"""Serial-bucket Pippenger MSM on the device — the port of the JAX package's
ops/msm_serial.py (its readback planner with one fixed window width c = 8).

One MSM of k scalar vectors over an n-point source:

  digits   host: signed c=8 recode (ops/msm.signed_digits), k*W windows of
           NB = 128 buckets each; uploaded once as int8 [k*W, n].
  plan     device: one sort of the packed (bucket, source row) entries and
           one bincount; the [k*W*NB] bucket counts are the only readback.
           The host picks the round budget T and splits a bucket with c
           entries over ceil(c / T) consecutive pool lanes, so every lane
           has at most T entries (bit-vector witnesses put ~n entries into
           one bucket).  idx [T, P] is a gather from the sorted stream.
  K1       bucket_accumulate: one thread per pool lane, T mixed adds of
           gathered affine rows [x | y | 2d*x*y] (128-byte rows).
  K3       bucket_merge: one thread per bucket sums its lanes in order.
  K4       window_sums: one thread per window, sum_b b*S_b by the running
           sum (2*NB adds, no scalar multiplies).
  K5       horner: one thread per vector, windows high to low, c doublings
           and one add per window.
  readback the k extended points, once; compressed on the host.

Each kernel's wrapper checks its tensors' dtype, shape, contiguity and
device, launches the CUDA kernel for CUDA tensors (csrc/msm_kernels.cu,
built by bulletproof_gadgets_tpu_torch.native) and counts the launch in
LAUNCHES; for CPU tensors it runs the plain PyTorch version beside it,
which computes the same limbs.  Indices are in range by construction of
`plan` over a [2n+1]-row source (checked on the host in
`msm_many_digits_t`), so the wrappers read nothing back; the plain
versions check them.

Not ported, because they serve the TPU: the static tight/safe plans and
their overflow re-run (remote round trips), the Mosaic/VMEM constants (pool
cap, lane padding, round chunks, scan width caps), point chunking, and the
round-chunked accumulator-carrying kernel (ROADMAP Queue 2, K2).
"""
import numpy as np
import torch

from . import curve, fp
from .msm import signed_digits
from .. import native
from ..core.ristretto import RistrettoPoint, batch_normalize, P as _P, D as _D
from ..core.scalar import L

NL = fp.NL
C = 8                     # window width (byte-wise digit recode)
NB = 1 << (C - 1)         # 128 buckets per window
W = 32 * 8 // C           # 32 windows per 256-bit scalar
ROW = 32                  # int32 per source row: x | y | t2d | 2 pad = 128 B
_2D = 2 * _D % _P
# Round budget: T = ceil(entries / _LANE_TARGET), at least _MIN_ROUNDS, so
# the pool has ~_LANE_TARGET lanes (one thread each; ~4 resident 128-thread
# blocks per SM on 132 SMs want >= 64k) whatever the table size.
_LANE_TARGET = 1 << 16
_MIN_ROUNDS = 4

LAUNCHES = {"bucket_accumulate": 0, "bucket_merge": 0, "window_sums": 0,
            "horner": 0}


# ---------------------------------------------------------------------------
# wrapper plumbing

def _check(t, name, shape):
    """int32, contiguous, and the given shape (None = any extent)."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _kernels(*tensors):
    """The loaded kernel library for CUDA tensors, None for CPU tensors."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("tensors on different devices")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return native.load()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name, rc):
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError {rc}")


# ---------------------------------------------------------------------------
# K1: bucket accumulation

def bucket_accumulate(src, idx):
    """src int32 [S, ROW] affine rows; idx int32 [T, P] row per (round,
    lane) -> int32 [4, NL, P] extended sums, lane p = sum_t row idx[t, p].

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel_rows.
    Bound on the H100: integer multiplies (7 field muls of 100 32x32->64
    products per entry); the gather moves 128 B per entry.  Design: one
    thread per lane keeps its accumulator in registers for all T rounds;
    idx[t, :] is read coalesced across the warp and each row with eight
    16-byte loads."""
    _check(src, "src", (None, ROW))
    _check(idx, "idx", (None, None))
    lib = _kernels(src, idx)
    if lib is None:
        return bucket_accumulate_plain(src, idx)
    t, p = idx.shape
    out = torch.empty((4, NL, p), dtype=torch.int32, device=src.device)
    if p == 0:
        return out
    _launched("bucket_accumulate", lib.bpg_bucket_accumulate(
        src.data_ptr(), idx.data_ptr(), t, p, out.data_ptr(), _stream(src)))
    return out


def bucket_accumulate_plain(src, idx):
    if bool(((idx < 0) | (idx >= src.shape[0])).any()):
        raise ValueError("idx: row index outside src")
    t, p = idx.shape
    acc = curve.identity((p,), src.device)
    rows = src.to(torch.int64)
    for r in range(t):
        g = rows[idx[r].long()].t()                       # [ROW, P]
        acc = curve.madd(acc, (g[0:NL], g[NL:2 * NL], g[2 * NL:3 * NL]))
    return curve.stack(acc)


# ---------------------------------------------------------------------------
# K3: merge of split buckets

def bucket_merge(pool, offs, sub):
    """pool int32 [4, NL, P]; bucket b owns lanes offs[b] .. offs[b] +
    sub[b] - 1 (int32 [M] each) -> int32 [4, NL, M] bucket sums (the
    identity for empty buckets).

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_merge_scan_kernel
    (a segmented Hillis-Steele scan read at each bucket's last lane).
    Bound on the H100: the longest bucket, one thread adding its sub[b]
    lanes in sequence (a bit-vector bucket splits over ~n/T lanes).
    Design: a bucket's lanes are contiguous, so one thread per bucket
    reads them in order — no scan steps, no segment ids."""
    _check(pool, "pool", (4, NL, None))
    _check(offs, "offs", (None,))
    _check(sub, "sub", (offs.shape[0],))
    lib = _kernels(pool, offs, sub)
    if lib is None:
        return bucket_merge_plain(pool, offs, sub)
    m = offs.shape[0]
    out = torch.empty((4, NL, m), dtype=torch.int32, device=pool.device)
    _launched("bucket_merge", lib.bpg_bucket_merge(
        pool.data_ptr(), pool.shape[2], offs.data_ptr(), sub.data_ptr(), m,
        out.data_ptr(), _stream(pool)))
    return out


def bucket_merge_plain(pool, offs, sub):
    if bool(((offs < 0) | (sub < 0) | (offs + sub > pool.shape[2])).any()):
        raise ValueError("offs/sub: lanes outside pool")
    m = offs.shape[0]
    pts = curve.unstack(pool)
    acc = [c.clone() for c in curve.identity((m,), pool.device)]
    live = (sub > 0).nonzero().flatten()
    if live.numel():
        for a, c in zip(acc, curve.select(pts, offs[live].long())):
            a[:, live] = c
    for j in range(1, int(sub.max()) if m else 0):
        live = (sub > j).nonzero().flatten()
        res = curve.padd(curve.select(acc, live),
                         curve.select(pts, (offs[live] + j).long()))
        for a, r in zip(acc, res):
            a[:, live] = r
    return curve.stack(acc)


# ---------------------------------------------------------------------------
# K4: weighted window sums

def window_sums(buckets):
    """buckets int32 [4, NL, nw*NB] (bucket j of window w holds digit j+1)
    -> int32 [4, NL, nw], window w = sum_j (j+1) * S[w*NB + j].

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_window_scan_kernel
    (a double masked suffix scan).  Bound on the H100: latency — 2*NB
    dependent adds per window with only k*W windows in flight.  Design: one
    thread per window runs the running-sum recurrence (running += S_j,
    total += running, j from NB-1 down), the same adds as the scan without
    its log-step waste."""
    _check(buckets, "buckets", (4, NL, None))
    if buckets.shape[2] % NB:
        raise ValueError("buckets: lane count not a multiple of NB")
    lib = _kernels(buckets)
    if lib is None:
        return window_sums_plain(buckets)
    nw = buckets.shape[2] // NB
    out = torch.empty((4, NL, nw), dtype=torch.int32, device=buckets.device)
    _launched("window_sums", lib.bpg_window_sums(
        buckets.data_ptr(), nw, NB, out.data_ptr(), _stream(buckets)))
    return out


def window_sums_plain(buckets):
    nw = buckets.shape[2] // NB
    b = curve.unstack(buckets.view(4, NL, nw, NB))
    running = curve.identity((nw,), buckets.device)
    total = curve.identity((nw,), buckets.device)
    for j in range(NB - 1, -1, -1):
        running = curve.padd(running, tuple(c[..., j] for c in b))
        total = curve.padd(total, running)
    return curve.stack(total)


# ---------------------------------------------------------------------------
# K5: Horner across windows

def horner(ws, k):
    """ws int32 [4, NL, k*W] window sums (vector-major) -> int32
    [4, NL, k], vector v = sum_w 2^(C*w) * ws[v*W + w].

    Replaces bulletproof_gadgets_tpu/ops/msm_serial.py:_horner_kernel.
    Bound on the H100: latency — (W-1)*(C+1) dependent point operations
    per vector, k threads.  Design: one thread per vector, dedicated
    doublings (4 squarings + 4 muls) instead of the TPU's padd(acc, acc)."""
    _check(ws, "ws", (4, NL, k * W))
    lib = _kernels(ws)
    if lib is None:
        return horner_plain(ws, k)
    out = torch.empty((4, NL, k), dtype=torch.int32, device=ws.device)
    _launched("horner", lib.bpg_horner(
        ws.data_ptr(), k, W, C, out.data_ptr(), _stream(ws)))
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
# planner

def plan(digits_t, n: int):
    """digits_t [k*W, n] signed digits (device) -> (idx int32 [T, P],
    offs int32 [M], sub int32 [M]) with M = k*W*NB.  Identity row = 2n
    (source layout [P | -P | identity])."""
    dev = digits_t.device
    wt = digits_t.shape[0]
    m = wt * NB
    d = digits_t.to(torch.int32)
    a = d.abs()
    live = a > 0
    key = (torch.arange(wt, dtype=torch.int32, device=dev)[:, None] * NB
           + a - 1)[live]
    i = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    row = torch.where(d < 0, i + n, i)[live]
    counts = torch.bincount(key, minlength=m).cpu().numpy()   # the readback
    sv = (torch.sort((key.to(torch.int64) << 32) | row.to(torch.int64))
          .values & 0xFFFFFFFF).to(torch.int32)
    total = int(counts.sum())
    t = max(_MIN_ROUNDS, -(-total // _LANE_TARGET))
    sub = -(-counts // t)                          # lanes per bucket
    offs = np.concatenate([[0], np.cumsum(sub)[:-1]])
    coffs = np.concatenate([[0], np.cumsum(counts)])
    pool = int(sub.sum())
    sub_d = torch.from_numpy(sub.astype(np.int32)).to(dev)
    offs_d = torch.from_numpy(offs.astype(np.int32)).to(dev)
    if pool == 0:
        return (torch.empty((t, 0), dtype=torch.int32, device=dev),
                offs_d, sub_d)
    coffs_d = torch.from_numpy(coffs.astype(np.int64)).to(dev)
    seg = torch.repeat_interleave(torch.arange(m, device=dev),
                                  sub_d.long(), output_size=pool)
    lane = torch.arange(pool, device=dev)
    # lane p of bucket b takes sorted entries coffs[b] + (p - offs[b])*T + r
    first = coffs_d[seg] + (lane - offs_d[seg].long()) * t
    rank = first[None, :] + torch.arange(t, device=dev)[:, None]
    idx = torch.where(rank < coffs_d[seg + 1][None, :],
                      sv[rank.clamp(max=total - 1)],
                      torch.full_like(sv[:1], 2 * n))
    return idx.contiguous(), offs_d, sub_d


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


def points_from_cols(cols):
    """int32 [4, NL, k] -> k host points (one readback)."""
    arr = cols.cpu().numpy()
    xs, ys, zs, ts = (fp.limbs_to_ints(arr[c]) for c in range(4))
    return [RistrettoPoint(*v) for v in zip(xs, ys, zs, ts)]


def msm_many_digits_t(digits_t: np.ndarray, src, n: int):
    """digits_t int8 [k*W, n] (host) over the device rows src -> k points."""
    k = digits_t.shape[0] // W
    if digits_t.shape[1] != n or src.shape[0] != 2 * n + 1:
        raise ValueError(f"digits {digits_t.shape} / source rows "
                         f"{src.shape[0]}: expected [k*W, {n}] / {2 * n + 1}")
    idx, offs, sub = plan(torch.from_numpy(digits_t).to(src.device), n)
    pool = bucket_accumulate(src, idx)
    buckets = bucket_merge(pool, offs, sub)
    return points_from_cols(horner(window_sums(buckets), k))


def msm_many(vectors, src, n: int):
    """vectors: k lists of n ints (any residue mod L) -> k points."""
    digits = np.concatenate([signed_digits([v % L for v in vec], C)
                             for vec in vectors], axis=1)      # [n, k*W]
    return msm_many_digits_t(
        np.ascontiguousarray(digits.T, dtype=np.int8), src, n)


def msm(scalars, points, device) -> RistrettoPoint:
    """One MSM over an arbitrary point list (the verifier's dynamic part
    when it is large enough): preps a source per call."""
    src = torch.from_numpy(prep_source(list(points))).to(device)
    return msm_many([[int(s) for s in scalars]], src, len(points))[0]


class GeneratorTable:
    """Device-resident MSM table over [G_0..G_{N-1} | H_0..H_{N-1} | B |
    B_blinding]: the source rows upload once per proof size; every prover
    and verifier MSM against it is one `msm_many` launch chain.  Digit-level
    and on-device-encoding entry points come with the device vectors."""

    __slots__ = ("N", "m", "src")
    supports_digits = False

    def __init__(self, G, H, B, B_blinding, device):
        assert len(H) == len(G)
        self.N = len(G)
        self.m = 2 * self.N + 2
        self.src = torch.from_numpy(
            prep_source(list(G) + list(H) + [B, B_blinding])).to(device)

    @classmethod
    def from_rows(cls, rows: np.ndarray, device) -> "GeneratorTable":
        """Table over source rows made elsewhere ([2m+1, ROW])."""
        t = cls.__new__(cls)
        t.m = (rows.shape[0] - 1) // 2
        t.N = (t.m - 2) // 2
        t.src = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
        return t

    def msm_many(self, vectors):
        for v in vectors:
            assert len(v) == self.m, (len(v), self.m)
        return msm_many(vectors, self.src, self.m)
