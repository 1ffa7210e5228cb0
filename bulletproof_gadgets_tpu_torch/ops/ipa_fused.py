"""The inner-product argument with its vectors and its transcript on the
device: the port of the JAX package's ops/ipa_fused.create (single proof)
and create_batched.

Per round: the pending challenge fold of a, b, gc, hc (ops/ipa_device._fold),
the L and R scalars and their signed digits, one MSM of k = 2 over the
current table (ops/msm_serial.msm_digits_t), the two points' compression
(ops/ristretto_device.ristretto_compress) and the round's Fiat-Shamir step
(ops/strobe_device.transcript_round: the L and R absorbs, the challenge u,
u^-1 as Montgomery rows), all on the device; u and u^-1 stay there for the
next fold.  Every FOLD_AT rounds of a segment, while the folded table keeps
FOLD_MIN generators and at least 4 rounds remain, the table is folded
(ops/ipa_fold.materialize) and gc, hc restart at one.  After the last
round one readback returns the L/R encodings, a0, b0 and the final STROBE
state and positions, which are written back into the host transcript
(strobe_device.write_back), so the caller goes on with it as if the host
had run the rounds.

The device transcript: the JAX package moves compression and STROBE onto
the TPU (ops/ristretto_device, strobe_device, keccak_device) so that a
round needs no host step and the argument pays one remote readback.  In
eager PyTorch a 255-bit inversion chain would be ~265 sequential field
muls of ~10 launches each, and f1600 24 rounds of ~50 ops, so here each is
a hand-written kernel of one launch per round (csrc/ristretto.cu, csrc/
transcript.cu).  The MSM's schedule is built on the device from the shape
(msm_serial.schedule), its pool bound from the L/R structure (`_lr_live`),
so a round reads nothing back: each round's pool excess stays on the
device and is read, and checked, in the one readback of `_finish`.

Rounds over a table of more than msm_serial.POINT_CHUNK points run point
chunked inside msm_serial.msm_digits_t (its K7 combine), so there is no
`_round_combine` here.  Byte output is identical to the host loop of
core/ipa.py (tests/test_torch_ipa.py).

`create_batched` runs the arguments of a group of proofs over one table
(lang/batch): per round one batched fold and digit build, one MSM of k = 2B,
one compression of its 2B points and one transcript step for the B
transcripts, no table fold.  Each transcript keeps its own byte positions,
so unlike the JAX package (whose static positions need one byte layout per
group) it takes proofs of any commitment count together.
"""
import functools

import numpy as np
import torch

from . import fl, flvec, ipa_fold, msm_serial, strobe_device
from .ipa_device import _fold, _scalars, round_masks
from ..core.scalar import L
from ..utils import profiling


def _inputs(dev, a, b, G_factors, H_factors):
    """(a, b) as device std rows and the factors as Montgomery rows (ints
    are uploaded; device rows pass through)."""
    def std(v):
        return (v if isinstance(v, torch.Tensor)
                else fl.to_limbs([s % L for s in v], dev))

    def mont(v):
        return v if isinstance(v, torch.Tensor) else flvec.to_mont(v, dev)
    return std(a), std(b), mont(G_factors), mont(H_factors)


@functools.lru_cache(maxsize=8)
def _lr_live(m: int, k: int):
    """msm_serial.msm_digits_t's live_cols for a round's digits over an
    m-point table [G | H | B | B_blinding] (k = 2B vectors: each proof's L
    and R): a G or H point has a non-zero scalar in at most one of a
    proof's L and R (ipa_device._scalar_rows: the position's half picks
    which), B in both (c_L * w, c_R * w), B_blinding in neither."""
    live = np.full(m, k // 2, dtype=np.int64)
    live[m - 2], live[m - 1] = k, 0
    live.setflags(write=False)
    return live


def _round_msm(dig, src, m, layout):
    """One round's L and R encodings uint8 [k, 32] and its MSM's pool
    excess (a device scalar, read in `_finish`)."""
    return msm_serial.msm_digits_enc(
        dig, src, m, layout, _lr_live(m, dig.shape[0] // msm_serial.W))


def _finish(transcripts, encs, excess, a_d, b_d, state, meta):
    """The one readback: encodings [rounds, B, 2, 32], the rounds' pool
    excesses, a0 and b0 [B, NW], states and positions; raises if a round's
    pool passed its bound, else writes the states back into the
    transcripts.  -> [(L_vec, R_vec, a0, b0)] per transcript."""
    nb, rounds = len(transcripts), len(encs)
    flat = torch.cat([torch.stack(encs).reshape(-1).to(torch.int64),
                      torch.stack(excess).reshape(-1),
                      torch.stack([a_d, b_d], 1).reshape(-1),
                      state.reshape(-1).to(torch.int64),
                      meta.reshape(-1).to(torch.int64)])
    flat = profiling.readback(flat).numpy()
    sizes = [rounds * nb * 64, rounds, 2 * nb * fl.NW, nb * 200, nb * 3]
    parts, off = [], 0
    for size in sizes:
        parts.append(flat[off:off + size])
        off += size
    if parts[1].max() > 0:
        msm_serial.raise_excess(int(parts[1].max()))
    enc = parts[0].astype("uint8").reshape(rounds, nb, 2, 32)
    ab = fl.limbs_to_ints(parts[2])
    out = []
    for i, t in enumerate(transcripts):
        strobe_device.write_back(t, parts[3][200 * i:200 * (i + 1)],
                                 parts[4][3 * i:3 * (i + 1)])
        out.append(([bytes(enc[r, i, 0]) for r in range(rounds)],
                    [bytes(enc[r, i, 1]) for r in range(rounds)],
                    ab[2 * i], ab[2 * i + 1]))
    return out


def create(transcript, table, w_scalar: int, G_factors, H_factors, a, b,
           fold_at: int = ipa_fold.FOLD_AT,
           fold_min: int = ipa_fold.FOLD_MIN):
    """The IPA rounds over the device table `table` (msm_serial
    GeneratorTable with N = len(a)).  `transcript` is the host transcript
    right after the ipp domain separator; on return it holds the state
    after the L/R absorbs and challenges.  w_scalar: int; a, b: ints or
    device std rows [n, NW]; G_factors, H_factors: ints or device
    Montgomery rows [n, NW] (ops/fl).  Returns (L_vec, R_vec, a0, b0) with
    L/R compressed and a0, b0 canonical ints."""
    dev = table.src.device
    n_full = len(a)
    assert table.N == n_full and n_full > 1
    a_d, b_d, gc, hc = _inputs(dev, a, b, G_factors, H_factors)
    wr2 = fl.to_limbs([w_scalar * fl.R * fl.R % L], dev)[0]
    state, meta = strobe_device.snapshot([transcript], dev)
    masks = round_masks(n_full, dev)
    src, n_seg, seg_masks, local = table.src, n_full, masks, 0
    u, encs, excess = None, [], []
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
        enc, ex = _round_msm(dig, src, 2 * n_seg + 2, table.layout)
        enc = enc.view(1, 2, 32)
        state, meta, u_rows = strobe_device.transcript_round(state, meta,
                                                             enc)
        encs.append(enc)
        excess.append(ex)
        u = u_rows[0].unbind(0)
        local += 1
    prev = seg_masks[local - 1]
    a_d, b_d, _, _ = _fold(a_d, b_d, gc, hc, *u, prev["ga"], prev["hi"])
    return _finish([transcript], encs, excess, a_d[:1], b_d[:1], state,
                   meta)[0]


def create_batched(transcripts, table, w_scalars, G_factors_list,
                   H_factors_list, a_list, b_list):
    """`create` for a group of proofs over the one device table `table`:
    per-proof lists of the arguments of `create` -> [(L_vec, R_vec, a0,
    b0)] per proof, each equal to what `create` gives it.  One proof, or a
    table of more than POINT_CHUNK points (its MSMs chunk, and `create`
    folds it), runs `create` per proof; groups of more than
    max_stack_k() // 2 proofs split, each group a call of its own.

    Spans: ipa.create_batched around the work of a call that does it (a
    call that splits its group records none itself, so the work counts
    once), with ipa.create per proof where it runs serially; counters
    ipa.serial_proofs and ipa.batched_proofs."""
    args = list(zip(transcripts, w_scalars, G_factors_list, H_factors_list,
                    a_list, b_list))
    if len(args) == 1 or table.m > msm_serial.POINT_CHUNK:
        profiling.count("ipa.serial_proofs", len(args))
        outs = []
        with profiling.span("ipa.create_batched"):
            for t, w, gf, hf, av, bv in args:
                with profiling.span("ipa.create"):
                    outs.append(create(t, table, w, gf, hf, av, bv))
        return outs
    k_cap = max(1, msm_serial.max_stack_k() // 2)
    if len(args) > k_cap:
        outs = []
        for i in range(0, len(args), k_cap):
            cols = list(zip(*args[i:i + k_cap]))
            outs += create_batched(cols[0], table, *cols[1:])
        return outs
    profiling.count("ipa.batched_proofs", len(args))
    span = profiling.begin("ipa.create_batched")
    dev = table.src.device
    n_full = len(a_list[0])
    assert table.N == n_full and n_full > 1
    ins = [_inputs(dev, *v) for v in zip(a_list, b_list, G_factors_list,
                                         H_factors_list)]
    a_d, b_d, gc, hc = (torch.stack(v) for v in zip(*ins))   # [B, n, NW]
    wr2 = fl.to_limbs([w * fl.R * fl.R % L for w in w_scalars],
                      dev)[:, None, :]                   # [B, 1, NW]
    state, meta = strobe_device.snapshot(transcripts, dev)
    masks = round_masks(n_full, dev)
    u, encs, excess = None, [], []
    for rnd, mk in enumerate(masks):
        if rnd:
            prev = masks[rnd - 1]
            a_d, b_d, gc, hc = _fold(a_d, b_d, gc, hc, *u, prev["ga"],
                                     prev["hi"])
        dig = _scalars(a_d, b_d, gc, hc, wr2, mk)       # [B*64, m]
        enc, ex = _round_msm(dig, table.src, table.m, table.layout)
        enc = enc.view(-1, 2, 32)
        state, meta, u_rows = strobe_device.transcript_round(state, meta,
                                                             enc)
        encs.append(enc)
        excess.append(ex)
        u = u_rows[:, :, None].unbind(1)                 # [B, 1, NW] each
    a_d, b_d, _, _ = _fold(a_d, b_d, gc, hc, *u, masks[-1]["ga"],
                           masks[-1]["hi"])
    outs = _finish(transcripts, encs, excess, a_d[:, 0], b_d[:, 0], state,
                   meta)
    profiling.end(span)
    return outs
