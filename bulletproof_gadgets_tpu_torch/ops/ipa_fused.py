"""The inner-product argument with its vectors on the device: the port of the
JAX package's ops/ipa_fused.create (single proof).

Per round: the pending challenge fold of a, b, gc, hc (ops/ipa_device._fold),
the L and R scalars and their signed digits, all on the device; one MSM of
k = 2 over the current table (ops/msm_serial.msm_digits_t); one readback of
the two points.  Compression, the Merlin absorbs and the challenge run on
the host (core/ristretto, utils/merlin), and u, u^-1 go up as two
Montgomery rows.  Every FOLD_AT rounds of a segment, while the folded table
keeps FOLD_MIN generators and at least 4 rounds remain, the table is folded
(ops/ipa_fold.materialize) and gc, hc restart at one.

Why the transcript stays on the host: the JAX package moves compression and
STROBE onto the TPU (ops/ristretto_device, strobe_device, keccak_device) so
that XLA fuses a round into one program and the argument pays one remote
readback.  Eager PyTorch fuses nothing: a 255-bit inversion chain is ~265
sequential field muls of ~10 launches each, and f1600 is 24 rounds of ~30
ops per permutation, thousands of launches per round against a host step of
about a millisecond.

Not ported: the point-chunked rounds (`_round_combine`, which needs K7) and
`create_batched` (the batched-proving slice).  Byte output is identical to
the host loop of core/ipa.py (tests/test_torch_ipa.py).
"""
import torch

from . import fl, flvec, ipa_fold, msm_serial
from .ipa_device import _fold, _scalars, round_masks
from ..core.scalar import L
from ..core.transcript import append_point, challenge_scalar


def create(transcript, table, w_scalar: int, G_factors, H_factors, a, b,
           fold_at: int = ipa_fold.FOLD_AT,
           fold_min: int = ipa_fold.FOLD_MIN):
    """The IPA rounds over the device table `table` (msm_serial
    GeneratorTable with N = len(a)).  `transcript` is the host transcript
    right after the ipp domain separator; the L/R absorbs and challenges
    go into it.  w_scalar, G_factors, H_factors, a, b: ints.  Returns
    (L_vec, R_vec, a0, b0) with L/R compressed and a0, b0 canonical ints."""
    dev = table.src.device
    n_full = len(a)
    assert table.N == n_full and n_full > 1
    a_d = fl.to_limbs([s % L for s in a], dev)
    b_d = fl.to_limbs([s % L for s in b], dev)
    gc = flvec.to_mont(G_factors, dev)
    hc = flvec.to_mont(H_factors, dev)
    wr2 = fl.to_limbs([w_scalar * fl.R * fl.R % L], dev)[0]
    masks = round_masks(n_full, dev)
    src, n_seg, seg_masks, local = table.src, n_full, masks, 0
    u = None
    L_vec, R_vec = [], []
    for rnd in range(len(masks)):
        if local:
            prev = seg_masks[local - 1]
            a_d, b_d, gc, hc = _fold(a_d, b_d, gc, hc, *u, prev["ga"],
                                     prev["hi"])
        if (local == fold_at and (n_seg >> fold_at) >= fold_min
                and len(masks) - rnd >= 4):
            src = ipa_fold.materialize(src, gc, hc, n_seg, fold_at,
                                       2 * n_seg + 2)
            n_seg >>= fold_at
            a_d, b_d = a_d[:n_seg], b_d[:n_seg]
            gc = hc = fl.const(fl.R, a_d).expand(n_seg, fl.NW)
            seg_masks, local = round_masks(n_seg, dev), 0
        dig = _scalars(a_d, b_d, gc, hc, wr2, seg_masks[local])
        cols = msm_serial.msm_digits_t(dig, src, 2 * n_seg + 2)
        p_l, p_r = msm_serial.points_from_cols(cols)
        L_vec.append(p_l.compress())
        R_vec.append(p_r.compress())
        append_point(transcript, b"L", L_vec[-1])
        append_point(transcript, b"R", R_vec[-1])
        ch = challenge_scalar(transcript, b"u").v % L
        u = flvec.to_mont([ch, pow(ch, L - 2, L)], dev).unbind(0)
        local += 1
    prev = seg_masks[local - 1]
    a_d, b_d, _, _ = _fold(a_d, b_d, gc, hc, *u, prev["ga"], prev["hi"])
    a0, b0 = fl.limbs_to_ints(torch.stack([a_d[0], b_d[0]]))
    return L_vec, R_vec, a0, b0
