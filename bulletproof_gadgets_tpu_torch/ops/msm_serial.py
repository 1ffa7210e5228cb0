"""Serial-bucket Pippenger MSM on the device — the port of the JAX package's
ops/msm_serial.py (its shape-static device schedule with one fixed window
width c = 8).

One MSM of k scalar vectors over an n-point source:

  digits   signed c=8 recode, k*W windows of NB = 128 buckets each, int8
           [k*W, n]: on the host (ops/msm.signed_digits, uploaded once) or
           on the device (ops/flvec.digits_device).
  schedule device, from the shape alone (no readback): the round budget T
           and the pool's lane count P come from a bound on the live
           (non-zero) entries; one sort of the packed (bucket, source row)
           slots, then searchsorted and cumsum give each bucket's entries
           and lanes: a bucket with c entries splits over ceil(c / T)
           consecutive pool lanes, so every lane has at most T entries
           (bit-vector witnesses put ~n entries into one bucket), and
           lanes past the buckets' own take the identity row.  The lanes
           the buckets fill go out as a device scalar, read with the
           result; P bounds them (`schedule`).  `idx_rows` gathers rounds
           t0..t1 of idx [T, P] from the sorted stream.
  K1       bucket_accumulate: one thread per pool lane, up to T mixed
           adds of gathered affine rows [x | y | 2d*x*y] (128-byte rows),
           in radix 2^32 (csrc/field32.cuh), stopping at the lane's first
           entry of the identity row (the source's last); canonical limbs
           out.
  K2       bucket_accumulate_cont: K1 started from a carried pool (the
           round chunks below).
  K3       bucket_merge: a group of G lanes per bucket (G from the pool's
           lanes per bucket, `merge_shape`), a whole warp per long bucket;
           lane j sums the bucket's lanes j, j+G, ..., then a shuffle tree
           (ceil(sub/32) - 1 + 5 dependent adds for a long bucket).
  K4       window_sums: one warp per window, sum_b b*S_b with no scalar
           multiplies: each lane sums four buckets, then a suffix scan and
           a tree reduction across the warp (19 dependent point operations
           per window).
  K5       horner: one warp per vector, windows high to low, c doublings
           and one add per window, each field multiplication of a point
           operation spread over 8 lanes.
  K7       point_sum (point chunks only, below): the chunks' window sums
           added lane-wise in one launch.
  result   the k extended points [4, NL, k] on the device; the caller
           reads them back (points_from_cols) or compresses them there
           (msm_digits_enc: ops/ristretto_device.ristretto_compress, uint8
           [k, 32] encodings).

Layouts of the bucket accumulation (`LAYOUTS`, the `layout` argument of
msm_digits_t / GeneratorTable, engine.register's `msm_layout`; the JAX
package's BPG_TPU_MSM_ROWS / BPG_TPU_MSM_RCHUNK switches):
  rows     K1 / K2 gather each lane's source row inside the kernel (the
           default, as in the JAX package).
  cols     `gather_cols` first builds the rounds-leading coordinate blocks
           int32 [T, 3*NL, P] (x | y | t2d limbs of round t, limb-major),
           then K8 bucket_accumulate_cols reads them coalesced; past the
           slot budget K8 runs the first round chunk and K9
           bucket_accumulate_cols_cont each later one, so one chunk's
           gather exists at a time.
  flat     `gather_flat` builds one int32 [3*NL, T*P] gather (lane p's
           round t at column t*P + p) and K10 bucket_accumulate_flat runs
           all T rounds; never round-chunked (the JAX package chunks only
           with more than one round per grid step).
The three give the same limbs (the same mixed adds in the same order).

Each kernel's wrapper checks its tensors' dtype, shape, contiguity and
device, launches the CUDA kernel for CUDA tensors (csrc/msm_kernels.cu,
built by bulletproof_gadgets_tpu_torch.native) and counts the launch in
LAUNCHES (native.LAUNCHES); for CPU tensors it runs the plain PyTorch
version beside it, which computes the same limbs.  Indices are in range by
construction of `schedule` over a [2n+1]-row source (checked on the host
in `msm_digits_t`), so the wrappers read nothing back; the plain versions
check them.

Point chunks: a source of more than POINT_CHUNK = 2^17 points is cut into
contiguous chunks of at most 2^17 points.  Each chunk runs schedule -> K1
-> K3 -> K4 to its [4, NL, k*W] window sums, with idx pointing into the
one [2n+1, ROW] source (rows lo..hi, n+lo..n+hi and the identity 2n: no
per-chunk copy), and the D chunks' window sums, stacked [D, 4, NL, k*W],
are added lane-wise in chunk order by one K7 launch (`point_sum`) before
one K5.  On the H100 a chunk's two row ranges (2 x 16 MB) fit in the 50
MB L2, where a 2^17-gens table's rows (64 MB) do not (a 2^16-gens table
fits whole: there K1's time per entry is the same with and without
chunks, PERF.md).

Round chunks: when a point chunk's T*P slots pass SLOT_BUDGET = 18 * 2^20
(the JAX package's `_SLOT_BUDGET`, so the same launches chunk in both
packages), its rounds run in chunks of max(1, SLOT_BUDGET // P): K1 on the
first, K2 carrying the [4, NL, P] pool through each later one.  The JAX
reason is the TPU's gathered-row transient; here it is the planner's: the
idx rows of a chunk are built from [tc, P] int64 ranks and an int32 gather
and where (about 24 B a slot), so no [T, P] array larger than one round
chunk exists (~450 MB at the budget; at the sizes measured so far the
schedule's sort sets the peak instead, PERF.md).  Batched proving reaches
it: three `merkle32` proofs stack k = 9 vectors over a 2^17-point chunk.

Stacked vectors: one launch takes at most max_stack_k() = 11 vectors (the
JAX package's cap, so batched proofs group as they do there); wider digit
matrices split along the vector axis.

Entries: `msm_many` recodes host scalar vectors; `msm_digits_t` takes
signed digits already on the device (the device IPA and the verifier's
table MSM) and returns the points as device columns, read back by the
caller; `msm_digits_enc` (the commitments, the IPA rounds) returns their
encodings, compressed on the device; `window_sums_t` stops before K5
(parallel/sharded_serial adds the ranks' window sums first).

Not ported, because they serve the TPU: the tight plan and its overflow
re-run (the bound here is the safe one, so nothing re-runs), the
Mosaic/VMEM constants (`_select_t`, lane padding, the rounds per grid step,
scan width caps).
"""
from typing import NamedTuple

import numpy as np
import torch

from . import curve, fp, ristretto_device
from .msm import signed_digits
from .. import native
from ..core.ristretto import RistrettoPoint, batch_normalize, P as _P, D as _D
from ..core.scalar import L

NL = fp.NL
C = 8                     # window width (byte-wise digit recode)
NB = 1 << (C - 1)         # 128 buckets per window
W = 32 * 8 // C           # 32 windows per 256-bit scalar
LANES = 32                # a warp: per window (K4), per long bucket (K3)
BUCKETS_PER_LANE = NB // LANES
ROW = 32                  # int32 per source row: x | y | t2d | 2 pad = 128 B
_2D = 2 * _D % _P
# Round budget: T = ceil(live_max / _LANE_TARGET), at least _MIN_ROUNDS,
# live_max a bound on the live entries (`pool_bound`), so a full pool has
# ~_LANE_TARGET lanes (one thread each; ~4 resident 128-thread blocks per
# SM on 132 SMs want >= 64k) whatever the table size.
_LANE_TARGET = 1 << 16
_MIN_ROUNDS = 4
POINT_CHUNK = 1 << 17     # most source points per chunk (msm_digits_t)
SLOT_BUDGET = 18 * 2**20  # most T*P slots per K1/K2 launch (msm_digits_t)

LAUNCHES = native.LAUNCHES       # every kernel's count, K6's included
LAYOUTS = ("rows", "cols", "flat")


def check_layout(layout):
    if layout not in LAYOUTS:
        raise ValueError(f"unknown MSM layout {layout!r}, expected one of "
                         f"{LAYOUTS}")


# ---------------------------------------------------------------------------
# K1: bucket accumulation

def bucket_accumulate(src, idx):
    """src int32 [S, ROW] affine rows; idx int32 [T, P] row per (round,
    lane) -> int32 [4, NL, P] extended sums, lane p = sum_t row idx[t, p]
    over the rounds before its first entry of row S - 1 (the schedule's
    identity row, after a lane's entries: `schedule`).

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel_rows.
    Bound on the H100: integer multiplies (7 field muls of 80 32x32->64
    products per entry: 64 for the product, 16 for its fold); the gather
    moves 128 B per entry.  Design: one thread per lane keeps its
    accumulator in registers for all T rounds; idx[t, :] is read coalesced
    across the warp and each row with eight 16-byte loads; the adds run in
    radix 2^32 with PTX carry chains (csrc/field32.cuh), and the pool is
    written as canonical limbs."""
    native.check(src, "src", (None, ROW))
    native.check(idx, "idx", (None, None))
    lib = native.kernels_for(src, idx)
    if lib is None:
        return bucket_accumulate_plain(src, idx)
    t, p = idx.shape
    out = torch.empty((4, NL, p), dtype=torch.int32, device=src.device)
    if p == 0:
        return out
    native.launched("bucket_accumulate", lib.bpg_bucket_accumulate(
        src.data_ptr(), idx.data_ptr(), t, p, src.shape[0] - 1,
        out.data_ptr(), native.stream(src)))
    return out


def bucket_accumulate_plain(src, idx):
    return _accumulate_plain(src, idx,
                             curve.identity((idx.shape[1],), src.device))


def _accumulate_plain(src, idx, acc):
    if bool(((idx < 0) | (idx >= src.shape[0])).any()):
        raise ValueError("idx: row index outside src")
    src3 = src[:, :3 * NL]
    return _madd_rounds(acc, (
        _mark_identity(src3, idx[r:r + 1], src.shape[0] - 1)[0].t()
        for r in range(idx.shape[0])))


def _mark_identity(src, idx, ident):
    """src's rows gathered by idx [T, P] -> [T, P, cols], with x limb 0 set
    to -1 in the slots of row `ident` (the schedule's identity row: canonical
    limbs are never negative), where the bucket accumulation stops."""
    g = src.index_select(0, idx.reshape(-1).long())
    g[:, 0] = torch.where(idx.reshape(-1) == ident, -1, g[:, 0])
    return g.view(idx.shape[0], idx.shape[1], src.shape[1])


def _madd_rounds(acc, rounds):
    """acc plus each round's affine columns ([>= 3*NL, P]: x | y | t2d
    limbs), by mixed addition in round order -> int32 [4, NL, P], the
    canonical limbs of each coordinate (the kernels' output rule: they add
    in radix 2^32, csrc/field32.cuh, so only values are shared).

    A lane stops at its first column marked as the identity row (x limb 0
    = -1, `_mark_identity`): a schedule gives each lane its entries as a
    prefix of its rounds and that row after them, so the kernels skip
    those adds, and here the stopped lanes keep their sums (an add of the
    identity would change the limbs, not the point)."""
    live = None
    for g in rounds:
        g = g.to(torch.int64)
        x, y, t2d = g[0:NL], g[NL:2 * NL], g[2 * NL:3 * NL]
        live = x[0] >= 0 if live is None else live & (x[0] >= 0)
        lanes = live.nonzero().flatten()          # the adds of this round
        if lanes.numel() == 0:
            break
        new = curve.madd(tuple(c[:, lanes] for c in acc),
                         (x[:, lanes], y[:, lanes], t2d[:, lanes]))
        acc = tuple(c.index_copy(1, lanes, v) for c, v in zip(acc, new))
    return curve.stack(tuple(fp.canonical(c) for c in acc))


def _carried_pool(acc):
    """A pool to carry on from (K2, K9): int32 [4, NL, P] limbs in
    [0, 2^w), as K1, K2 and K8-K10 write them; the kernels read it by
    shifts (csrc/field32.cuh fe8_from_limbs), so other limbs raise here."""
    top = fp.const([1 << w for w in fp.W], acc[0])
    if bool(((acc < 0) | (acc >= top)).any()):
        raise ValueError("acc: limbs outside [0, 2^w): not a pool written "
                         "by K1, K2 or K8-K10")
    return curve.unstack(acc)


# ---------------------------------------------------------------------------
# K2: bucket accumulation with the pool carried in

def bucket_accumulate_cont(src, idx, acc):
    """K1 started from a pool: src int32 [S, ROW]; idx int32 [T, P]; acc
    int32 [4, NL, P] -> int32 [4, NL, P], lane p = acc_p + sum_t row
    idx[t, p], the mixed adds in round order (so K1 over rounds [0, t0)
    and K2 over [t0, T) give K1's limbs over [0, T)).

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:
    _bucket_kernel_rows_cont.  Bound on the H100: K1's, integer multiplies
    (7 field muls of 80 32x32->64 products per entry), plus the pool read
    and written once (2 x 160 B per lane).  Design: K1's body (one thread
    per lane, the accumulator in registers for the chunk's rounds) with the
    accumulator loaded from acc instead of set to the identity; its own C
    entry and launch counter.  acc's limbs must lie in [0, 2^w), as K1, K2
    and K8-K10 write them (the plain version raises otherwise)."""
    native.check(src, "src", (None, ROW))
    native.check(idx, "idx", (None, None))
    native.check(acc, "acc", (4, NL, idx.shape[1]))
    lib = native.kernels_for(src, idx, acc)
    if lib is None:
        return bucket_accumulate_cont_plain(src, idx, acc)
    t, p = idx.shape
    out = torch.empty_like(acc)
    if p == 0:
        return out
    native.launched("bucket_accumulate_cont",
                    lib.bpg_bucket_accumulate_cont(
                        src.data_ptr(), idx.data_ptr(), t, p, src.shape[0] - 1,
                        acc.data_ptr(), out.data_ptr(), native.stream(src)))
    return out


def bucket_accumulate_cont_plain(src, idx, acc):
    return _accumulate_plain(src, idx, _carried_pool(acc))


# ---------------------------------------------------------------------------
# the pre-transposed layouts: gathers, K8, K9, K10

def gather_cols(src, idx):
    """src int32 [S, ROW]; idx int32 [T, P] -> int32 [T, 3*NL, P]: round
    t's x | y | t2d limbs of the rows idx[t, :], limb-major (the JAX
    package's _gather_g3; the rows are already int32, so nothing widens);
    a slot of the identity row (the source's last) has x limb 0 = -1, the
    mark where K8-K10 stop a lane."""
    g = _mark_identity(src[:, :3 * NL], idx, src.shape[0] - 1)
    return g.transpose(1, 2).contiguous()


def gather_flat(src, idx):
    """src int32 [S, ROW]; idx int32 [T, P] -> int32 [3*NL, T*P]: column
    t*P + p holds the x | y | t2d limbs of row idx[t, p] (the JAX package's
    flat gather for _bucket_kernel2d), marked as gather_cols marks them."""
    return _mark_identity(src[:, :3 * NL], idx, src.shape[0] - 1).reshape(
        -1, 3 * NL).t().contiguous()


def bucket_accumulate_cols(g):
    """K1's function on gathered coordinate blocks: g int32 [T, 3*NL, P]
    (gather_cols) -> int32 [4, NL, P], lane p = sum_t of round t's column
    p, the mixed adds in round order.

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel.
    Bound on the H100: the larger of the integer multiplies (7 field muls
    of 80 32x32->64 products per live entry) and 120 B of gathered
    coordinates per slot read once, two costs of one size.  Design: one
    thread per lane, the accumulator in registers for all T rounds; limb l
    of round t is g[t, l, p], so the 30 loads of a round are each
    coalesced across the warp (no row gather in the kernel: the gather
    pass before it pays for the random access)."""
    native.check(g, "g", (None, 3 * NL, None))
    lib = native.kernels_for(g)
    if lib is None:
        return bucket_accumulate_cols_plain(g)
    t, _, p = g.shape
    out = torch.empty((4, NL, p), dtype=torch.int32, device=g.device)
    if p == 0:
        return out
    native.launched("bucket_accumulate_cols", lib.bpg_bucket_accumulate_cols(
        g.data_ptr(), t, p, out.data_ptr(), native.stream(g)))
    return out


def bucket_accumulate_cols_plain(g):
    return _madd_rounds(curve.identity((g.shape[2],), g.device), g.unbind(0))


def bucket_accumulate_cols_cont(g, acc):
    """K8 started from a pool: g int32 [T, 3*NL, P]; acc int32 [4, NL, P]
    -> int32 [4, NL, P], lane p = acc_p + sum_t of round t's column p (so
    K8 over rounds [0, t0) and K9 over [t0, T) give K8's limbs over
    [0, T)).

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel_cont.
    Bound on the H100: K8's, plus the pool read and written once (2 x 160
    B per lane).  Design: K8's body with the accumulator loaded from acc;
    its own C entry and launch counter.  acc as for K2."""
    native.check(g, "g", (None, 3 * NL, None))
    native.check(acc, "acc", (4, NL, g.shape[2]))
    lib = native.kernels_for(g, acc)
    if lib is None:
        return bucket_accumulate_cols_cont_plain(g, acc)
    t, _, p = g.shape
    out = torch.empty_like(acc)
    if p == 0:
        return out
    native.launched("bucket_accumulate_cols_cont",
                    lib.bpg_bucket_accumulate_cols_cont(
                        g.data_ptr(), t, p, acc.data_ptr(), out.data_ptr(),
                        native.stream(g)))
    return out


def bucket_accumulate_cols_cont_plain(g, acc):
    return _madd_rounds(_carried_pool(acc), g.unbind(0))


def bucket_accumulate_flat(g, t: int, p: int):
    """K1's function on one flat gather: g int32 [3*NL, t*p] (gather_flat)
    -> int32 [4, NL, p], lane j = sum over rounds r of column r*p + j.

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel2d
    (one round per grid step).  Bound on the H100: K8's (7 field muls of
    80 products per live entry, 120 B per slot read once).  Design: K8's
    body with round stride p and limb stride t*p (int64 offsets: the flat
    gather of a large MSM passes 2^31 elements), so every load is still
    coalesced across the warp; one launch runs all t rounds."""
    if t < 0 or p < 0:
        raise ValueError(f"rounds {t} / lanes {p}: must not be negative")
    native.check(g, "g", (3 * NL, t * p))
    lib = native.kernels_for(g)
    if lib is None:
        return bucket_accumulate_flat_plain(g, t, p)
    out = torch.empty((4, NL, p), dtype=torch.int32, device=g.device)
    if p == 0:
        return out
    native.launched("bucket_accumulate_flat", lib.bpg_bucket_accumulate_flat(
        g.data_ptr(), t, p, out.data_ptr(), native.stream(g)))
    return out


def bucket_accumulate_flat_plain(g, t: int, p: int):
    return _madd_rounds(curve.identity((p,), g.device),
                        (g[:, r * p:(r + 1) * p] for r in range(t)))


# ---------------------------------------------------------------------------
# K3: merge of split buckets

def merge_shape(p: int, m: int):
    """K3's group width G and long-bucket bound for a pool of p lanes over
    m buckets: with avg = ceil(p / m), G is the largest power of two <=
    LANES with 8G <= avg (1 if none), and a bucket of more than 2 avg
    lanes is long (summed by a whole warp)."""
    avg = -(-p // m) if m else 0
    g = 1
    while g < LANES and 16 * g <= avg:
        g *= 2
    return g, 2 * avg


def bucket_merge(pool, offs, sub):
    """pool int32 [4, NL, P]; bucket b owns lanes offs[b] .. offs[b] +
    sub[b] - 1 (int32 [M] each) -> int32 [4, NL, M] bucket sums (the
    identity for empty buckets).

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_merge_scan_kernel
    (a segmented Hillis-Steele scan read at each bucket's last lane).
    Bound on the H100: the longest bucket's chain of adds if one thread
    sums a bucket (a bit-vector bucket splits over ~n/T lanes: 137 on the
    example's verifier launch).  Design (csrc/msm_kernels.cu): a group of
    G lanes per bucket, a whole warp per long bucket (merge_shape), the
    buckets dealt to warps strided so that neighbouring long buckets go
    to different warps; lane j of a group sums lanes j, j + G, ... in
    order, then a shuffle tree sums the group's partials, in the order
    that bucket_merge_plain spells out."""
    native.check(pool, "pool", (4, NL, None))
    native.check(offs, "offs", (None,))
    native.check(sub, "sub", (offs.shape[0],))
    lib = native.kernels_for(pool, offs, sub)
    if lib is None:
        return bucket_merge_plain(pool, offs, sub)
    m = offs.shape[0]
    out = torch.empty((4, NL, m), dtype=torch.int32, device=pool.device)
    if m == 0:
        return out
    g, lng = merge_shape(pool.shape[2], m)
    native.launched("bucket_merge", lib.bpg_bucket_merge(
        pool.data_ptr(), pool.shape[2], offs.data_ptr(), sub.data_ptr(), m,
        g, lng, out.data_ptr(), native.stream(pool)))
    return out


def bucket_merge_plain(pool, offs, sub):
    """K3's adds in K3's order, for all buckets at once.  Bucket b sums
    its lanes L_i = offs[b] + i with g = LANES lanes if it is long, else
    G (merge_shape): lane j < cnt = min(sub, g) forms Q_j = L_j + L_j+g +
    L_j+2g + ..., then for d = g/2, .., 2, 1 lane j < d with j + d < cnt
    sets Q_j += Q_j+d; the bucket is Q_0 (the identity for sub = 0)."""
    if bool(((offs < 0) | (sub < 0) | (offs + sub > pool.shape[2])).any()):
        raise ValueError("offs/sub: lanes outside pool")
    m = offs.shape[0]
    pts = curve.unstack(pool)
    g, lng = merge_shape(pool.shape[2], m)
    sub = sub.long()
    width = torch.where(sub > lng, LANES, g)
    cnt = torch.minimum(sub, width)
    # the groups' lanes that hold lanes of their bucket, bucket by bucket
    b = torch.repeat_interleave(torch.arange(m, device=pool.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt          # bucket b's lane 0
    j = torch.arange(b.shape[0], device=pool.device) - first[b]
    lane, step_b = offs.long()[b] + j, width[b]
    q = list(curve.select(pts, lane))

    def step(live, other):
        for a, r in zip(q, curve.padd(curve.select(q, live), other)):
            a[:, live] = r
    r = 1
    while True:                        # Q_j += L_j+rg for r = 1, 2, ...
        live = (j + r * step_b < sub[b]).nonzero().flatten()
        if not live.numel():
            break
        step(live, curve.select(pts, lane[live] + r * step_b[live]))
        r += 1
    d = LANES // 2
    while d:                           # Q_j += Q_j+d while j + d < cnt
        live = ((j < d) & (j + d < cnt[b])).nonzero().flatten()
        if live.numel():
            step(live, curve.select(q, live + d))
        d //= 2
    acc = [c.clone() for c in curve.identity((m,), pool.device)]
    full = (cnt > 0).nonzero().flatten()
    for a, c in zip(acc, curve.select(q, first[full])):
        a[:, full] = c
    return curve.stack(acc)


# ---------------------------------------------------------------------------
# K4: weighted window sums

def window_sums(buckets):
    """buckets int32 [4, NL, nw*NB] (bucket j of window w holds digit j+1)
    -> int32 [4, NL, nw], window w = sum_j (j+1) * S[w*NB + j].

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_window_scan_kernel
    (a double masked suffix scan, 2 x 7 steps).  Bound on the H100: the
    dependent chain of point operations per window; the running sum is 2*NB
    = 256 of them, one thread's, with only k*W windows in flight.  Design
    (csrc/msm_kernels.cu): one warp per window, lane s owning buckets
    4s..4s+3 (LANES x BUCKETS_PER_LANE); the chain is 19 operations, in the
    order that window_sums_plain spells out."""
    native.check(buckets, "buckets", (4, NL, None))
    if buckets.shape[2] % NB:
        raise ValueError("buckets: lane count not a multiple of NB")
    lib = native.kernels_for(buckets)
    if lib is None:
        return window_sums_plain(buckets)
    nw = buckets.shape[2] // NB
    out = torch.empty((4, NL, nw), dtype=torch.int32, device=buckets.device)
    native.launched("window_sums", lib.bpg_window_sums(
        buckets.data_ptr(), nw, NB, out.data_ptr(), native.stream(buckets)))
    return out


def window_sums_plain(buckets):
    """K4's adds in K4's order, for all windows at once.  Lane s of a
    window holds its buckets S_4s+i (i < 4); with U_s their sum, T_s =
    sum_i (i+1) S_4s+i and V_s = U_s + .. + U_31, the window is
    sum_s T_s + 4 * sum_{s>=1} V_s."""
    nw = buckets.shape[2] // NB
    s = curve.unstack(buckets.view(4, NL, nw, LANES, BUCKETS_PER_LANE))

    def lanes(p, lo, hi):
        return tuple(c[..., lo:hi] for c in p)

    def join(*parts):
        return tuple(torch.cat(cs, -1) for cs in zip(*parts))
    run = tot = tuple(c[..., BUCKETS_PER_LANE - 1] for c in s)
    for i in range(BUCKETS_PER_LANE - 2, -1, -1):   # U_s, T_s: running sums
        run = curve.padd(run, tuple(c[..., i] for c in s))
        tot = curve.padd(tot, run)
    d = 1
    while d < LANES:                     # V_s += V_s+d while s + d < LANES
        run = join(curve.padd(lanes(run, 0, LANES - d),
                              lanes(run, d, LANES)),
                   lanes(run, LANES - d, LANES))
        d *= 2
    four = curve.dbl(curve.dbl(lanes(run, 1, LANES)))
    tot = join(lanes(tot, 0, 1), curve.padd(lanes(tot, 1, LANES), four))
    while d > 1:                         # Q_s += Q_s+d while s < d
        d //= 2
        tot = curve.padd(lanes(tot, 0, d), lanes(tot, d, 2 * d))
    return curve.stack(tuple(c[..., 0] for c in tot))


# ---------------------------------------------------------------------------
# K5: Horner across windows

def horner(ws, k):
    """ws int32 [4, NL, k*W] window sums (vector-major) -> int32
    [4, NL, k], vector v = sum_w 2^(C*w) * ws[v*W + w].

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_horner_kernel.
    Bound on the H100: latency — (W-1)*(C+1) = 279 dependent point
    operations per vector.  Design (csrc/msm_kernels.cu): one warp per
    vector; each point operation runs as levels of independent field
    products (dbl: 4 + 4, padd: 4 + 1 + 4), each product's ten int64
    column sums formed by 8 lanes and carried as fe_mul carries them.
    Dedicated doublings (4 squarings + 4 muls) instead of the TPU's
    padd(acc, acc); the limbs are horner_plain's."""
    native.check(ws, "ws", (4, NL, k * W))
    lib = native.kernels_for(ws)
    if lib is None:
        return horner_plain(ws, k)
    out = torch.empty((4, NL, k), dtype=torch.int32, device=ws.device)
    native.launched("horner", lib.bpg_horner(
        ws.data_ptr(), k, W, C, out.data_ptr(), native.stream(ws)))
    return out


def horner_plain(ws, k):
    x = curve.unstack(ws.view(4, NL, k, W))
    acc = tuple(c[..., W - 1] for c in x)
    for j in range(W - 2, -1, -1):
        for _ in range(C):
            acc = curve.dbl(acc)
        acc = curve.padd(acc, tuple(c[..., j] for c in x))
    return curve.stack(acc)


# ---------------------------------------------------------------------------
# K7: lane-wise sum over point chunks (the chunk combine)

def point_sum(ws):
    """ws int32 [D, 4, NL, n] (the window sums of D point chunks) -> int32
    [4, NL, n], lane i = ws[0]_i + ws[1]_i + ... + ws[D-1]_i, added in
    chunk order, as canonical limbs.

    Replaces bulletproof_gadgets_tpu/ops/pallas_curve.py:_padd_kernel
    (padd_cols, 512-lane blocks, launched D - 1 times over D chunks).
    Bound on the H100: at the chunk combine's k*W = 32-352 lanes, latency:
    one launch and one lane's chain of D - 1 unified adds (9 field muls
    each) with its canonicalizations, ~22 us at D = 2 (PERF.md); at wide
    n, the 9 field muls per lane and chunk against 160 bytes read per
    lane and chunk.  Design (csrc/msm_kernels.cu): one launch for all D
    chunks (D - 1 before), one thread per lane on the radix-2^32 core
    (csrc/field32.cuh), loads and stores coalesced across the warp."""
    native.check(ws, "ws", (None, 4, NL, None))
    if ws.shape[0] < 1:
        raise ValueError("ws: no chunks")
    lib = native.kernels_for(ws)
    if lib is None:
        return point_sum_plain(ws)
    d, _, _, n = ws.shape
    out = torch.empty((4, NL, n), dtype=torch.int32, device=ws.device)
    if n:
        native.launched("point_sum", lib.bpg_point_sum(
            ws.data_ptr(), d, n, out.data_ptr(), native.stream(ws)))
    return out


def point_sum_plain(ws):
    """The chained curve.padd over the chunks, then fp.canonical."""
    acc = curve.unstack(ws[0])
    for part in ws[1:]:
        acc = curve.padd(acc, curve.unstack(part))
    return curve.stack(tuple(fp.canonical(c) for c in acc))


# ---------------------------------------------------------------------------
# planner

class Schedule(NamedTuple):
    """One point chunk's bucket schedule (all device tensors but t, ident):
    lane p of the pool takes the sorted entries sv[first[p] + r] for
    rounds r with first[p] + r < end[p], else the identity row."""
    t: int                  # rounds T
    sv: torch.Tensor        # int32 [k*W*h] source rows, bucket-sorted (live
    #                         entries first)
    first: torch.Tensor     # int64 [P] lane p's first position in sv
    end: torch.Tensor       # int64 [P] end of lane p's bucket in sv
    offs: torch.Tensor      # int32 [M] bucket b's first lane
    sub: torch.Tensor       # int32 [M] bucket b's lane count
    ident: int              # the identity row 2n
    used: torch.Tensor      # int64 [] the lanes the buckets fill (<= P)

    @property
    def pool(self) -> int:
        return self.first.shape[0]


def pool_bound(wt: int, live_max: int):
    """(T, P) of a schedule over wt windows with at most live_max live
    entries: T = max(_MIN_ROUNDS, ceil(live_max / _LANE_TARGET)) and
    P = min(M, live_max) + ceil(live_max / T), M = wt*NB buckets.

    P bounds the lanes sum_b ceil(c_b / T) of any digits with at most
    live_max live entries (c_b of them in bucket b): ceil(c/T) <= 1 +
    floor(c/T) for c > 0, sum_b floor(c_b/T) <= floor(live/T), and at most
    min(M, live) buckets are non-empty."""
    t = max(_MIN_ROUNDS, -(-live_max // _LANE_TARGET))
    return t, min(wt * NB, live_max) + -(-live_max // t)


def schedule(digits_t, n: int, lo: int = 0, live_max: int = None
             ) -> Schedule:
    """digits_t [k*W, h] signed digits (device) of the source points lo ..
    lo+h-1 of an n-point source -> its Schedule, M = k*W*NB buckets, with
    no read to the host.  Source layout [P | -P | identity]: point lo+i is
    row lo+i, its negation row n+lo+i, the identity row 2n.

    T and P come from the shape (`pool_bound`) with live_max, a bound on
    the non-zero digits: the slot count k*W*h unless the caller knows a
    smaller one (msm_digits_t's live_cols).  The lanes the buckets really
    fill are `used`, a device scalar; lanes past them take the identity
    row.  A caller's bound that is too small makes used pass P: the plain
    version (digits on the CPU) raises here, and on a device the caller
    reads `used - P` with its result (msm_digits_t's excess) and raises
    there; the lanes past P are dropped and no kernel reads past the
    pool."""
    dev = digits_t.device
    wt, h = digits_t.shape
    m = wt * NB
    live_max = wt * h if live_max is None else min(live_max, wt * h)
    t, p = pool_bound(wt, live_max)
    d = digits_t.to(torch.int32)
    a = d.abs()
    key = torch.where(a > 0, torch.arange(wt, dtype=torch.int32,
                                          device=dev)[:, None] * NB + a - 1,
                      m)                       # dead slots sort last
    i = torch.arange(lo, lo + h, dtype=torch.int32, device=dev)[None, :]
    row = torch.where(d < 0, i + n, i)
    sk = torch.sort(((key.to(torch.int64) << 32)
                     | row.to(torch.int64)).reshape(-1)).values
    sv = (sk & 0xFFFFFFFF).to(torch.int32)
    # bucket b's entries are sv[coffs[b] : coffs[b+1]]
    coffs = torch.searchsorted(
        sk, torch.arange(m + 1, dtype=torch.int64, device=dev) << 32)
    sub = -(-(coffs[1:] - coffs[:-1]) // t)        # lanes per bucket
    csum = torch.cumsum(sub, 0)
    offs = csum - sub
    used = csum[-1]
    if dev.type == "cpu" and int(used) > p:
        raise_excess(int(used) - p)
    lane = torch.arange(p, device=dev)
    seg = torch.searchsorted(csum, lane, right=True).clamp(max=m - 1)
    # lane p of bucket b takes sorted entries coffs[b] + (p - offs[b])*T + r
    first = coffs[seg] + (lane - offs[seg]) * t
    end = torch.where(lane < used, coffs[seg + 1], 0)
    sub = torch.minimum(sub, (p - offs).clamp(min=0))     # lanes < P only
    return Schedule(t, sv, first, end, offs.to(torch.int32),
                    sub.to(torch.int32), 2 * n, used)


def raise_excess(excess: int):
    """An MSM's pool passed its bound by `excess` lanes: its points would
    be wrong, so nothing returns them."""
    raise RuntimeError(f"MSM schedule: the buckets fill {excess} lanes past "
                       "the pool bound P (a live-entry bound too small)")


def idx_rows(s: Schedule, t0: int, t1: int):
    """Rounds t0 .. t1-1 of the schedule's idx: int32 [t1 - t0, P], the
    source row each lane adds in each round (no larger array is made)."""
    dev = s.sv.device
    if s.pool == 0 or s.sv.shape[0] == 0:
        return torch.full((t1 - t0, s.pool), s.ident, dtype=torch.int32,
                          device=dev)
    rank = s.first[None, :] + torch.arange(t0, t1, device=dev)[:, None]
    return torch.where(rank < s.end[None, :],
                       s.sv[rank.clamp(max=s.sv.shape[0] - 1)],
                       torch.full_like(s.sv[:1], s.ident)).contiguous()


def plan(digits_t, n: int, lo: int = 0):
    """The whole idx of one point chunk at once: (idx int32 [T, P], offs
    int32 [M], sub int32 [M]) of `schedule`."""
    s = schedule(digits_t, n, lo)
    return idx_rows(s, 0, s.t), s.offs, s.sub


def accumulate(src, s: Schedule, slot_budget: int, layout: str = "rows"):
    """The pool int32 [4, NL, P] of one schedule in the given layout.
    rows: one K1 over all T rounds, or, when T*P passes slot_budget (0:
    never), K1 over the first max(1, slot_budget // P) rounds and K2 over
    each later chunk of as many.  cols: the same round chunks, each
    gathered (gather_cols) for K8, then K9.  flat: one gather_flat and one
    K10 over all T rounds, whatever the budget."""
    if layout == "flat":
        return bucket_accumulate_flat(gather_flat(src, idx_rows(s, 0, s.t)),
                                      s.t, s.pool)
    tc = s.t
    if slot_budget and s.t * s.pool > slot_budget:
        tc = max(1, slot_budget // s.pool)
    if layout == "rows":
        first, cont = bucket_accumulate, bucket_accumulate_cont
    else:
        first, cont = bucket_accumulate_cols, bucket_accumulate_cols_cont

    def chunk(t0):      # the kernel's inputs for rounds t0 .. t0 + tc - 1
        idx = idx_rows(s, t0, min(t0 + tc, s.t))
        return (src, idx) if layout == "rows" else (gather_cols(src, idx),)
    pool = first(*chunk(0))
    for t0 in range(tc, s.t, tc):   # one chunk's inputs exist at a time
        pool = cont(*chunk(t0), pool)
    return pool


def max_stack_k() -> int:
    """Most stacked scalar vectors per MSM launch: 11, the JAX package's
    max_stack_k (its lane pool of k*W*NB lanes under the TPU's 49,152-lane
    VMEM cap), kept so that batched proofs group as they do there.  On the
    H100 it bounds the schedule's sort: k*W*h int64 keys per point chunk
    (11 * 32 * 2^17 * 8 B = 369 MB)."""
    return 11


# ---------------------------------------------------------------------------
# sources and entry points

def prep_source(points) -> np.ndarray:
    """list[RistrettoPoint] -> host rows int32 [2n+1, ROW]:
    [P_0..P_{n-1} | -P_0..-P_{n-1} | identity], each row the canonical
    affine x | y | t2d = x*y*2d limbs (Z = 1, so the bucket step is a
    mixed add)."""
    n = len(points)
    aff = batch_normalize(points)
    xs = [pt.X for pt in aff]
    ys = [pt.Y for pt in aff]
    t2ds = [pt.T * _2D % _P for pt in aff]
    rows = np.zeros((2 * n + 1, ROW), dtype=np.int32)
    rows[:, 0:NL] = fp.ints_to_limbs(xs + [_P - x for x in xs] + [0]).T
    rows[:, NL:2 * NL] = fp.ints_to_limbs(ys + ys + [1]).T
    rows[:, 2 * NL:3 * NL] = fp.ints_to_limbs(
        t2ds + [_P - t for t in t2ds] + [0]).T
    return rows


def source_from_rows13(rows13) -> np.ndarray:
    """The JAX package's prep_source rows (int16 [S, 64]: x | y | t2d in
    20 13-bit limbs each) -> this package's rows int32 [S, ROW]."""
    rows13 = np.asarray(rows13)
    rows = np.zeros((rows13.shape[0], ROW), dtype=np.int32)
    for c in range(3):
        rows[:, c * NL:(c + 1) * NL] = fp.limbs13_to_limbs(
            rows13[:, 20 * c:20 * (c + 1)].T).T
    return rows


def points_from_cols(cols, excess=None):
    """int32 [4, NL, k] -> k host points (one readback, which also reads
    msm_digits_t's `excess` when given and raises if a pool passed its
    bound)."""
    flat = cols.reshape(-1).to(torch.int64)
    if excess is not None:
        flat = torch.cat([flat, excess.reshape(1)])
    arr = flat.cpu().numpy()
    if excess is not None and arr[-1] > 0:
        raise_excess(int(arr[-1]))
    arr = arr[:cols.numel()].reshape(cols.shape)
    xs, ys, zs, ts = (fp.limbs_to_ints(arr[c]) for c in range(4))
    return [RistrettoPoint(*v) for v in zip(xs, ys, zs, ts)]


def window_sums_t(digits_t, src, n: int, point_chunk: int = None,
                  slot_budget: int = None, layout: str = "rows",
                  live_cols=None):
    """msm_digits_t up to Horner: digits_t int8 [k*W, n] on src's device
    over the rows src -> (int32 [4, NL, k*W] window sums, vector-major,
    excess), with no read to the host.  Each point chunk runs schedule ->
    K1 (K2 past the slot budget) -> K3 -> K4, and one K7 launch adds the
    chunks' window sums; more than max_stack_k() vectors run in groups
    whose window sums are concatenated.  The arguments and excess are
    msm_digits_t's; parallel/sharded_serial combines these window sums
    across ranks before its Horner."""
    check_layout(layout)
    k = digits_t.shape[0] // W
    if (digits_t.shape != (k * W, n) or src.shape[0] != 2 * n + 1
            or digits_t.device != src.device
            or (live_cols is not None and len(live_cols) != n)):
        raise ValueError(f"digits {tuple(digits_t.shape)} on "
                         f"{digits_t.device} / source rows {src.shape[0]} on "
                         f"{src.device}: expected [k*W, {n}] / {2 * n + 1}"
                         " (live_cols: n entries)")
    k_max = max_stack_k()
    if k > k_max:
        parts = [window_sums_t(digits_t[v * W:(v + k_max) * W], src, n,
                               point_chunk, slot_budget, layout, live_cols)
                 for v in range(0, k, k_max)]
        return (torch.cat([ws for ws, _ in parts], dim=2),
                torch.stack([e for _, e in parts]).max())
    chunk = point_chunk or POINT_CHUNK
    budget = SLOT_BUDGET if slot_budget is None else slot_budget
    parts, excess = [], []
    for lo in range(0, max(n, 1), chunk):
        live_max = (None if live_cols is None else
                    W * int(np.sum(live_cols[lo:lo + chunk], dtype=np.int64)))
        s = schedule(digits_t[:, lo:lo + chunk], n, lo, live_max)
        parts.append(window_sums(bucket_merge(
            accumulate(src, s, budget, layout), s.offs, s.sub)))
        excess.append(s.used - s.pool)
    ws = parts[0] if len(parts) == 1 else point_sum(torch.stack(parts))
    return ws, torch.stack(excess).max()


def msm_digits_t(digits_t, src, n: int, point_chunk: int = None,
                 slot_budget: int = None, layout: str = "rows",
                 live_cols=None):
    """digits_t int8 [k*W, n] on src's device over the rows src ->
    (int32 [4, NL, k] extended points, excess), with no read to the host.
    excess is an int64 device scalar: the most lanes by which a chunk's
    buckets passed their pool bound P (<= 0: none did, and the points are
    right); a caller reads it with the points and raises if it is positive
    (points_from_cols, GeneratorTable, ops/ipa_fused).  On the CPU the
    schedule raises at once instead.

    live_cols (host ints [n], or None: k everywhere) bounds how many of the
    k vectors have a non-zero scalar at each source point; a point chunk
    lo..hi then has at most W * sum(live_cols[lo:hi]) live digits, its
    schedule's live_max (the IPA's L and R pass one: each table point is
    in at most one of them).  More than max_stack_k() vectors split into
    launches of at most that many.  Sources of more than `point_chunk`
    (default POINT_CHUNK) points run in chunks whose window sums one K7
    launch adds before Horner; a chunk of more than `slot_budget` (default
    SLOT_BUDGET; 0: no limit) T*P slots runs its rounds in chunks (K1,
    then K2; K8, then K9 under the cols layout).  `layout` is one of
    LAYOUTS (`accumulate`); every layout gives the same limbs.  The window
    sums are `window_sums_t`'s, then one K5 per group of vectors."""
    ws, excess = window_sums_t(digits_t, src, n, point_chunk, slot_budget,
                               layout, live_cols)
    k, k_max = ws.shape[2] // W, max_stack_k()
    return torch.cat([horner(ws[:, :, v * W:(v + k_max) * W].contiguous(),
                             min(k_max, k - v))
                      for v in range(0, k, k_max)], dim=2), excess


def msm_digits_enc(digits_t, src, n: int, layout: str = "rows",
                   live_cols=None):
    """msm_digits_t's points, compressed on the device: (uint8 [k, 32]
    RFC 9496 encodings (ops/ristretto_device.ristretto_compress), excess)."""
    cols, excess = msm_digits_t(digits_t, src, n, layout=layout,
                                live_cols=live_cols)
    return ristretto_device.ristretto_compress(cols), excess


def msm_many_digits_t(digits_t: np.ndarray, src, n: int,
                      layout: str = "rows"):
    """digits_t int8 [k*W, n] (host) over the device rows src -> k points."""
    return points_from_cols(*msm_digits_t(
        torch.from_numpy(digits_t).to(src.device), src, n, layout=layout))


def msm_many(vectors, src, n: int, layout: str = "rows"):
    """vectors: k lists of n ints (any residue mod L) -> k points."""
    digits = np.concatenate([signed_digits([v % L for v in vec], C)
                             for vec in vectors], axis=1)      # [n, k*W]
    return msm_many_digits_t(
        np.ascontiguousarray(digits.T, dtype=np.int8), src, n, layout)


def msm(scalars, points, device, layout: str = "rows") -> RistrettoPoint:
    """One MSM over an arbitrary point list (the verifier's dynamic part
    when it is large enough): preps a source per call."""
    src = torch.from_numpy(prep_source(list(points))).to(device)
    return msm_many([[int(s) for s in scalars]], src, len(points), layout)[0]


class GeneratorTable:
    """Device-resident MSM table over [G_0..G_{N-1} | H_0..H_{N-1} | B |
    B_blinding]: the source rows upload once per proof size; every prover
    and verifier MSM against it is one launch chain from device digits
    (`msm_digits`, `supports_digits`; `msm_digits_enc_launch` / `_finish`
    compress the points on the device and read back their encodings), and
    the device IPA (ops/ipa_fused) runs `msm_digits_t` on `src` directly,
    each in the table's `layout` (LAYOUTS)."""

    __slots__ = ("N", "m", "src", "layout")
    supports_digits = True

    def __init__(self, G, H, B, B_blinding, device, layout: str = "rows"):
        assert len(H) == len(G)
        check_layout(layout)
        self.N = len(G)
        self.m = 2 * self.N + 2
        self.src = torch.from_numpy(
            prep_source(list(G) + list(H) + [B, B_blinding])).to(device)
        self.layout = layout

    @classmethod
    def from_rows(cls, rows: np.ndarray, device) -> "GeneratorTable":
        """Table over source rows made elsewhere ([2m+1, ROW])."""
        t = cls.__new__(cls)
        t.m = (rows.shape[0] - 1) // 2
        t.N = (t.m - 2) // 2
        t.src = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
        t.layout = "rows"
        return t

    def msm_digits(self, digits_t):
        """Device digits int8 [k*W, m] (ops/flvec) -> k host points (one
        readback, the pool check with it)."""
        return points_from_cols(*msm_digits_t(digits_t, self.src, self.m,
                                              layout=self.layout))

    def msm_digits_enc_launch(self, digits_t):
        """Device digits int8 [k*W, m] -> their MSM's encodings, uint8
        [k, 32] on the device, with its pool excess (finish with
        msm_digits_enc_finish)."""
        return msm_digits_enc(digits_t, self.src, self.m, self.layout)

    @staticmethod
    def msm_digits_enc_finish(pending):
        """-> k 32-byte encodings (one readback, which also reads the pool
        excess and raises if it is positive)."""
        enc, excess = pending
        arr = torch.cat([enc.reshape(-1).to(torch.int64),
                         excess.reshape(1)]).cpu().numpy()
        if arr[-1] > 0:
            raise_excess(int(arr[-1]))
        return [bytes(row) for row in
                arr[:-1].astype(np.uint8).reshape(enc.shape)]
