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

Rounds over a table of more than msm_serial.POINT_CHUNK points run point
chunked inside msm_serial.msm_digits_t (its K7 combine), so there is no
`_round_combine` here.  Byte output is identical to the host loop of
core/ipa.py (tests/test_torch_ipa.py).

`create_batched` runs the arguments of a group of proofs over one table
(lang/batch): per round one batched fold and digit build, one MSM of k = 2B
and one readback of 2B points, no table fold.  Its transcripts are host
transcripts, so unlike the JAX package (whose device transcript needs one
byte layout per group) it takes proofs of any commitment count together.
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
    go into it.  w_scalar: int; a, b: ints or device std rows [n, NW];
    G_factors, H_factors: ints or device Montgomery rows [n, NW] (ops/fl).
    Returns (L_vec, R_vec, a0, b0) with L/R compressed and a0, b0
    canonical ints."""
    dev = table.src.device
    n_full = len(a)
    assert table.N == n_full and n_full > 1
    std = lambda v: (v if isinstance(v, torch.Tensor)            # noqa: E731
                     else fl.to_limbs([s % L for s in v], dev))
    mont = lambda v: (v if isinstance(v, torch.Tensor)           # noqa: E731
                      else flvec.to_mont(v, dev))
    a_d, b_d, gc, hc = std(a), std(b), mont(G_factors), mont(H_factors)
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
        cols = msm_serial.msm_digits_t(dig, src, 2 * n_seg + 2,
                                       layout=table.layout)
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


def create_batched(transcripts, table, w_scalars, G_factors_list,
                   H_factors_list, a_list, b_list):
    """`create` for a group of proofs over the one device table `table`:
    per-proof lists of the arguments of `create` -> [(L_vec, R_vec, a0,
    b0)] per proof, each equal to what `create` gives it.  One proof, or a
    table of more than POINT_CHUNK points (its MSMs chunk, and `create`
    folds it), runs `create` per proof; groups of more than
    max_stack_k() // 2 proofs split."""
    args = list(zip(transcripts, w_scalars, G_factors_list, H_factors_list,
                    a_list, b_list))
    if len(args) == 1 or table.m > msm_serial.POINT_CHUNK:
        return [create(t, table, w, gf, hf, av, bv)
                for t, w, gf, hf, av, bv in args]
    k_cap = max(1, msm_serial.max_stack_k() // 2)
    if len(args) > k_cap:
        outs = []
        for i in range(0, len(args), k_cap):
            cols = list(zip(*args[i:i + k_cap]))
            outs += create_batched(cols[0], table, *cols[1:])
        return outs
    dev = table.src.device
    n_full = len(a_list[0])
    assert table.N == n_full and n_full > 1
    std = lambda v: (v if isinstance(v, torch.Tensor)            # noqa: E731
                     else fl.to_limbs([s % L for s in v], dev))
    mont = lambda v: (v if isinstance(v, torch.Tensor)           # noqa: E731
                      else flvec.to_mont(v, dev))
    a_d = torch.stack([std(v) for v in a_list])          # [B, n, NW]
    b_d = torch.stack([std(v) for v in b_list])
    gc = torch.stack([mont(v) for v in G_factors_list])
    hc = torch.stack([mont(v) for v in H_factors_list])
    wr2 = fl.to_limbs([w * fl.R * fl.R % L for w in w_scalars],
                      dev)[:, None, :]                   # [B, 1, NW]
    masks = round_masks(n_full, dev)
    u = None
    outs = [([], []) for _ in transcripts]
    for rnd, mk in enumerate(masks):
        if rnd:
            prev = masks[rnd - 1]
            a_d, b_d, gc, hc = _fold(a_d, b_d, gc, hc, *u, prev["ga"],
                                     prev["hi"])
        dig = _scalars(a_d, b_d, gc, hc, wr2, mk)       # [B*64, m]
        pts = msm_serial.points_from_cols(
            msm_serial.msm_digits_t(dig, table.src, table.m,
                                    layout=table.layout))
        chs = []
        for i, (t, (L_vec, R_vec)) in enumerate(zip(transcripts, outs)):
            L_vec.append(pts[2 * i].compress())
            R_vec.append(pts[2 * i + 1].compress())
            append_point(t, b"L", L_vec[-1])
            append_point(t, b"R", R_vec[-1])
            ch = challenge_scalar(t, b"u").v % L
            chs += [ch, pow(ch, L - 2, L)]
        u = flvec.to_mont(chs, dev).view(-1, 2, 1, fl.NW).unbind(1)
    a_d, b_d, _, _ = _fold(a_d, b_d, gc, hc, *u, masks[-1]["ga"],
                           masks[-1]["hi"])
    ab = fl.limbs_to_ints(torch.stack([a_d[:, 0], b_d[:, 0]], dim=1))
    return [(L_vec, R_vec, ab[2 * i], ab[2 * i + 1])
            for i, (L_vec, R_vec) in enumerate(outs)]
