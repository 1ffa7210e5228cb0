"""The inner-product argument with its vectors sharded by row across the
mesh: the port of the JAX package's parallel/sharded_ipa.py.

On one device (ops/ipa_fused) the coefficient vectors a, b (std) and gc,
hc (Montgomery) are [n_full, NW] F_l rows.  Here rank s holds rows
s*n_loc .. (s+1)*n_loc - 1 (n_loc = n_full / D) of each, the rows of the
table columns it holds (parallel/sharded_serial's layout), and every round
runs with explicit collectives:

  * the cross rows a[ga], b[ga] (ga = pos -/+ half): while half >= n_loc a
    rank's cross rows are one whole block of another rank (`plan`); in
    round 0 that is a swap, one point-to-point exchange of [2, n_loc, NW],
    later several ranks need one block, so the blocks are all-gathered and
    the rank picks its own; once half < n_loc every cross row lies in the
    first 2*half rows of block 0, and only those are gathered.  The fold
    of the next round reuses these rows (its a and b are the ones they
    were taken from), so a round makes one exchange.
  * c_L * w and c_R * w: each rank's sums of its rows (ipa_device
    .round_terms, canonical below l), times w, all-reduced with sum.  The
    limbs of D canonical rows sum below D * 2^26, far inside int64, and
    flvec.reduce_sums brings the total back to canonical limbs.
  * the L and R digits are those of the rank's own table columns (the rank
    that holds B adds the c terms), so the MSM (ShardedGeneratorTable
    .msm_local) gathers only window sums; its points are compressed on the
    device (ristretto_compress) and the encodings read back and absorbed
    into the host transcript, as in the JAX package, whose sharded argument
    keeps the host transcript too.

The argument folds scalars, never the table (no K6, no transcript_round).
Shapes that do not shard (n_full % D != 0, or n_full / D < 2) run the same
round loop with the vectors replicated on every rank, through the sharded
table, as the JAX package's ipa_device.create does over a
ShardedGeneratorTable.  The bytes are those of one device.
"""
import torch

from . import mesh as mesh_mod
from ..core.scalar import L
from ..core.transcript import append_point, challenge_scalar
from ..ops import fl, flvec
from ..ops.ipa_device import (fold_crossed, lr_digits, lr_rows, round_masks,
                              round_terms)
from ..ops.ipa_fused import _inputs, _lr_live


def plan(n_full: int, n_loc: int, half: int):
    """(src, dst) pairs, dst = 0 .. D-1: shard dst's cross rows for a round
    of this half lie in shard src's block (half >= n_loc; the JAX
    package's _RoundFns._perm)."""
    n = 2 * half
    out = []
    for s in range(n_full // n_loc):
        pos0 = s * n_loc % n
        ga0 = pos0 + half if pos0 < half else pos0 - half
        out.append((ga0 // n_loc, s))
    return tuple(out)


def shards(n_full: int, d: int) -> bool:
    """Whether an argument of n_full rows shards over d ranks."""
    return d > 1 and n_full % d == 0 and n_full // d >= 2


def _crossed(mesh, a, b, ga, n_full: int, n_loc: int, half: int):
    """(a[ga], b[ga]) for this rank's rows, ga their global cross indices."""
    pair = torch.stack([a, b])
    if n_full == n_loc:                  # one part: every row is here
        pass
    elif half < n_loc:                   # all in shard 0's first 2*half rows
        pair = mesh_mod.all_gather(mesh, pair[:, :2 * half])[0]
    elif 2 * half == n_full:             # round 0: a swap of blocks
        pair = mesh_mod.exchange(mesh, pair, [
            s for s, _ in plan(n_full, n_loc, half)])
    else:
        pair = mesh_mod.all_gather(mesh, pair)[
            plan(n_full, n_loc, half)[mesh.index["shard"]][0]]
    idx = ga % n_loc
    return pair[0].index_select(0, idx), pair[1].index_select(0, idx)


def create(transcript, table, w_scalar: int, G_factors, H_factors, a, b):
    """The argument over the ShardedGeneratorTable `table` (N = len(a)), on
    every rank of its mesh: `transcript` is the host transcript right after
    the ipp domain separator and holds the rounds' absorbs and challenges
    on return.  w_scalar: int; a, b: ints or device std rows [n, NW];
    G_factors, H_factors: ints or device Montgomery rows [n, NW] (each the
    whole vector, the same on every rank).  -> (L_vec, R_vec, a0, b0) with
    L/R compressed and a0, b0 canonical ints, the same on every rank."""
    mesh, dev = table.mesh, table.src.device
    n_full = len(a)
    assert table.N == n_full and n_full > 1
    split = shards(n_full, mesh.shape["shard"])
    parts = mesh.shape["shard"] if split else 1
    n_loc = n_full // parts
    rows = slice(mesh.index["shard"] * n_loc, (mesh.index["shard"] + 1)
                 * n_loc) if split else slice(0, n_full)
    a_d, b_d, gc, hc = _inputs(dev, a[rows], b[rows], G_factors[rows],
                               H_factors[rows])
    wr2 = fl.to_limbs([w_scalar * fl.R * fl.R % L], dev)[0]
    live = _lr_live(table.m, 2)[table.cols_host]
    holds_b = not split or mesh.index["shard"] == parts - 1
    L_vec, R_vec, prev = [], [], None
    for rnd, mk in enumerate(round_masks(n_full, dev)):
        if prev is not None:
            a_d, b_d, gc, hc = fold_crossed(a_d, prev[0], b_d, prev[1], gc,
                                            hc, *u, prev[2])
        hi = mk["hi"][rows]
        a_x, b_x = _crossed(mesh, a_d, b_d, mk["ga"][rows], n_full, n_loc,
                            n_full >> (rnd + 1))
        # b[cs] = b[ga] on the rows that the sums keep
        prod_a, prod_b, sums = round_terms(a_d, a_x, b_x, b_x, gc, hc,
                                           mk["lo_i"][rows], mk["hi_i"][rows])
        c = fl.mont_mul(sums.unsqueeze(-2), wr2)     # c_L * w, c_R * w
        if split:
            c = flvec.reduce_sums(mesh_mod.all_reduce(mesh, c, "sum"))
        dig = lr_digits(lr_rows(prod_a, prod_b, hi,
                                c.unbind(0) if holds_b else None))
        Lb, Rb = table.msm_digits_enc_finish(table.msm_local_enc(
            dig if split else table.local(dig), live))
        append_point(transcript, b"L", Lb)
        append_point(transcript, b"R", Rb)
        L_vec.append(Lb)
        R_vec.append(Rb)
        x = challenge_scalar(transcript, b"u").v % L
        u = flvec.to_mont([x, pow(x, L - 2, L)], dev).unbind(0)
        prev = (a_x, b_x, hi)
    a_d, b_d, _, _ = fold_crossed(a_d, prev[0], b_d, prev[1], gc, hc, *u,
                                  prev[2])
    ab = torch.stack([a_d[0], b_d[0]])
    if split:                            # row 0 lives on shard 0
        ab = mesh_mod.all_gather(mesh, ab)[0]
    a0, b0 = fl.limbs_to_ints(ab)
    return L_vec, R_vec, a0, b0

