// The kernels of the serial-bucket MSM (ops/msm_serial.py): the four stages
// of one MSM (K1, K3, K4, K5), the bucket accumulation that carries its
// pool in across round chunks (K2), the lane-wise sum that combines the
// window sums of point chunks (K7), and the bucket accumulation of the
// pre-transposed layouts (K8, K9, K10), with a plain C interface for
// ctypes.  Each launcher runs on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 = launched).
//
// K1, K2, K7 and K8-K10 add in radix 2^32 (field32.cuh) and write
// canonical limbs; the other kernels use field.cuh's 10-limb core.
// Point arrays use the [4, 10, n] int32 layout of field.cuh; source rows
// are int32 [S, 32]: x limbs 0..9, y 10..19, t2d = x*y*2d 20..29, 2 pad.
// Gathered coordinates (K8-K10) hold the same 30 limbs per slot, limb-major:
// limb l of lane p's round t at g[t * round_stride + l * limb_stride + p].
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "field32.cuh"

using namespace bpg;

namespace {

constexpr int kThreads = 128;
// K1, K2 and K8-K10 ask for 5 resident blocks per SM: at most 96
// registers a thread (what K1 takes unbounded), so that the ~556 blocks of
// a ~71k-lane pool (msm_serial._LANE_TARGET) run in one wave of 660.
constexpr int kAccumulateBlocksPerSM = 5;

inline int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

// K1 (kCarry false): lane p accumulates the rows idx[0..T-1, p] by mixed
// addition, from the identity, up to its first entry of row `ident` (the
// schedule's identity row, the source's last: ops/msm_serial.schedule gives
// each lane its entries as a prefix of its rounds and that row after them,
// so a lane past the buckets' own stops at round 0 and a pool bound from
// the shape costs launch width, not adds; a real identity point elsewhere
// in the source is added as any other).  K2 (kCarry true): the same adds,
// started from lane p of acc_in (the pool of the earlier round chunks,
// canonical; a lane already past its entries writes it back as it came).  The adds run on field32.cuh's radix-2^32 core: the
// row's canonical limbs are converted once per round, the accumulator once
// per lane on the way in (K2) and out; the pool is written as canonical
// limbs.
template <bool kCarry>
__global__ void __launch_bounds__(kThreads, kAccumulateBlocksPerSM)
bucket_accumulate_kernel(const int32_t* __restrict__ src,
                         const int32_t* __restrict__ idx, int T, int P,
                         int64_t ident, const int32_t* __restrict__ acc_in,
                         int32_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  ge8 acc =
      kCarry ? ge8_from_limbs(ge_load(acc_in, P, lane)) : ge8_identity();
  for (int t = 0; t < T; t++) {
    const int64_t row = idx[(int64_t)t * P + lane];
    if (row == ident) break;                    // the lane's last entry
    const int4* r = reinterpret_cast<const int4*>(src + row * 32);
    int32_t w[32];
#pragma unroll
    for (int q = 0; q < 8; q++) {
      const int4 v = __ldg(r + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    fe x, y, t2d;
#pragma unroll
    for (int i = 0; i < 10; i++) {
      x.v[i] = w[i];
      y.v[i] = w[10 + i];
      t2d.v[i] = w[20 + i];
    }
    acc = ge8_madd(acc, fe8_from_limbs(x), fe8_from_limbs(y),
                   fe8_from_limbs(t2d));
  }
  ge_store(out, P, lane, ge8_to_canonical_limbs(acc));
}

// K8 (cols, kCarry false), K9 (cols, kCarry true) and K10 (flat): K1's
// mixed adds, with K1's stop at the lane's first entry of the identity
// row, on coordinates gathered beforehand (ops/msm_serial.gather_cols,
// gather_flat).  Lane p reads limb l of round t at
// g[t * round_stride + l * limb_stride + p]: consecutive lanes read
// consecutive addresses, so each of a round's 30 loads is coalesced across
// the warp (K1 instead reads one scattered 128-byte row per lane).  Bound on
// the H100: the larger of 7 field muls (560 32x32->64 products in
// field32.cuh's core, ~34 ps at the int32 multiply rate) per live slot and
// 120 bytes of coordinates (~36 ps at 3.35 TB/s) per slot read once; the
// two are of one size, so the design reads each byte once, coalesced, keeps
// K1's thread per lane with the accumulator in registers for all T rounds
// (K1's radix-2^32 adds), and leaves the random access to the gather pass
// before it.
// Offsets are int64: a flat gather of a large MSM passes 2^31 elements.
template <bool kCarry>
__global__ void __launch_bounds__(kThreads, kAccumulateBlocksPerSM)
bucket_accumulate_limbs_kernel(const int32_t* __restrict__ g,
                               int64_t round_stride, int64_t limb_stride,
                               int64_t T, int64_t P,
                               const int32_t* __restrict__ acc_in,
                               int32_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  ge8 acc =
      kCarry ? ge8_from_limbs(ge_load(acc_in, P, lane)) : ge8_identity();
  const int32_t* col = g + lane;
  for (int64_t t = 0; t < T; t++, col += round_stride) {
    const int32_t* q = col;
    // the gathers mark a slot of the identity row with x limb 0 = -1
    // (canonical limbs are never negative): the lane's last entry
    if (__ldg(q) < 0) break;
    fe x, y, t2d;
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) x.v[i] = __ldg(q);
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) y.v[i] = __ldg(q);
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) t2d.v[i] = __ldg(q);
    acc = ge8_madd(acc, fe8_from_limbs(x), fe8_from_limbs(y),
                   fe8_from_limbs(t2d));
  }
  ge_store(out, P, lane, ge8_to_canonical_limbs(acc));
}

// K3: bucket sums, replacing
// bulletproof_gadgets_tpu/ops/msm_serial.py:_merge_scan_kernel (a
// segmented Hillis-Steele scan read at each bucket's last lane).  Bucket b
// = the sum of its pool lanes L_i = offs[b] + i, i < sub[b].  Most buckets
// have about avg = ceil(P / M) lanes (2-17 on the main path), but some
// split over many more (a bit-vector's digit over ~n/T lanes: 55 on the
// example's commitment launch, 137 on its verifier launch), often side by
// side in one window; one thread per bucket adding its lanes in sequence
// makes the launch as long as the longest (~5 us per unified add).  Bound
// on the H100: the bytes (the pool read once), far below those chains; and
// a unified add costs a warp ~4.5 us of issue whether 1 or 32 of its lanes
// run it (the 64-bit multiply rate), so lanes must not idle either.
// Design: a group of G lanes per bucket, G the largest power of two <= 32
// with 8G <= avg (1 if none), 32 / G buckets per warp; a bucket of more
// than `lng` = 2 avg lanes is long, and a whole warp sums it instead.  Warp
// w < W = ceil(M G / 32) takes the short buckets among w, w + W, w + 2W,
// ... (strided, so that a window's long buckets fall to different warps),
// warp W + w the long ones among the same buckets, one after another.
// With g = 32 for a long bucket, else G, and cnt = min(sub, g):
//   1. lane j < cnt of the bucket's group forms Q_j = L_j + L_j+g +
//      L_j+2g + ... in increasing order;
//   2. a tree by shuffles: for d = g/2, ..., 2, 1, lane j < d with
//      j + d < cnt sets Q_j += Q_j+d.
// An add happens only where both operands hold lanes of the bucket: a
// bucket of one lane is a copy, an empty one the identity.  The longest
// chain is ceil(sub / g) - 1 + log2 g adds per bucket (9 at sub = 137,
// from 136; at most 2 avg - 1 for a short bucket at G = 1), summed over
// the long buckets of one warp.  This order of adds is the kernel's
// specification: ops/msm_serial.bucket_merge_plain performs the same adds
// in the same order (ops/msm_serial.merge_shape gives G and lng).
constexpr int kMergeWarps = 4;

// steps 1 and 2 for one bucket (lanes o .. o + s - 1 of the pool) by a
// group of g lanes, this lane being lane j of it: Q_0 in lane j = 0
__device__ __forceinline__ ge merge_group(const int32_t* __restrict__ pool,
                                          int P, int64_t o, int s, int g,
                                          int j, int cnt) {
  ge acc = ge_identity();
  if (j < cnt) {                               // 1. Q_j
    acc = ge_load(pool, P, o + j);
#pragma unroll 1
    for (int i = j + g; i < s; i += g)
      acc = ge_add(acc, ge_load(pool, P, o + i));
  }
#pragma unroll 1
  for (int d = g / 2; d > 0; d >>= 1) {        // 2. the tree
    const ge q = ge_shfl_down(acc, d);
    if (j < d && j + d < cnt) acc = ge_add(acc, q);
  }
  return acc;
}

__global__ void __launch_bounds__(32 * kMergeWarps)
bucket_merge_kernel(const int32_t* __restrict__ pool, int P,
                    const int32_t* __restrict__ offs,
                    const int32_t* __restrict__ sub, int M, int G, int lng,
                    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, per_warp = 32 / G;
  const int64_t W = ((int64_t)M + per_warp - 1) / per_warp;
  const int64_t w = (int64_t)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (w < W) {                                 // the short buckets
    const int64_t b = w + (lane / G) * W;
    const int s = b < M ? sub[b] : 0;
    const bool mine = b < M && s <= lng;
    const int j = lane & (G - 1);
    const ge acc = merge_group(pool, P, mine ? offs[b] : 0, s, G, j,
                               mine ? min(s, G) : 0);
    if (mine && j == 0) ge_store(out, M, b, acc);
  } else if (w < 2 * W) {                      // the long ones, in order
    const int64_t w0 = w - W;
    const int64_t b = w0 + lane * W;
    unsigned longs = __ballot_sync(
        0xffffffffu, lane < per_warp && b < M && sub[b] > lng);
    while (longs) {
      const int64_t lb = w0 + (int64_t)(__ffs(longs) - 1) * W;
      longs &= longs - 1;
      const int ls = sub[lb];
      const ge q = merge_group(pool, P, offs[lb], ls, 32, lane, min(ls, 32));
      if (lane == 0) ge_store(out, M, lb, q);
    }
  }
}

// K4: window sums, replacing
// bulletproof_gadgets_tpu/ops/msm_serial.py:_window_scan_kernel (a double
// Hillis-Steele suffix scan over each window's buckets, 2 x 7 steps of
// unified adds).  Window w = sum_j (j + 1) * S_j over its NB = 128 buckets.
// Bound on the H100: the dependent chain of point operations per window
// (not bytes: 20 KB of buckets per window).  The running sum (run += S_j,
// total += run) is 256 dependent adds by one thread, ~5.4 us each on the
// H100, and the 32-288 windows of a launch leave most SMs idle.  Design: one
// warp per window, two per block (the example's k=3 launch, 96 windows, on
// 48 SMs); lane s owns buckets 4s .. 4s+3, which the [4, NL, nw*NB] layout
// holds as one int4 per limb row, so the warp stages its window's 20 KB in
// shared memory by 40 coalesced 512-byte loads.  Then
//   1. lane s forms U_s = S_4s + .. + S_4s+3 and T_s = sum_i (i+1) S_4s+i by
//      the running sum over its four buckets, top down (6 adds);
//   2. a suffix scan by shuffles turns U_s into V_s = U_s + .. + U_31
//      (5 steps: V_s += V_s+d for d = 1, 2, 4, 8, 16 while s + d < 32);
//   3. lane s >= 1 forms Q_s = T_s + 4 V_s (2 doublings, 1 add; Q_0 = T_0);
//   4. a tree reduction by shuffles sums the Q_s into lane 0 (5 steps:
//      Q_s += Q_s+d for d = 16, 8, 4, 2, 1 while s < d),
// since sum_j (j+1) S_j = sum_s T_s + 4 sum_s s U_s and sum_s s U_s =
// sum_{s>=1} V_s.  The longest chain is 6 + 5 + 3 + 5 = 19 point operations
// per window (from 256).  This order of adds is the kernel's specification:
// ops/msm_serial.window_sums_plain performs the same adds in the same
// order, so the two agree limb for limb.
constexpr int kNB = 128;
constexpr int kWinPerBlock = 2;

__global__ void __launch_bounds__(32 * kWinPerBlock)
window_sums_kernel(const int32_t* __restrict__ buckets, int nw,
                   int32_t* __restrict__ out) {
  // stage[warp][r][i][s]: limb row r (coordinate r / 10, limb r % 10) of
  // bucket 4s + i, so the 32 lanes read a bucket's row without conflicts
  __shared__ int32_t stage[kWinPerBlock][40][4][32];
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWinPerBlock + (threadIdx.x >> 5);
  if (w >= nw) return;                         // the whole warp
  int32_t(*s)[4][32] = stage[threadIdx.x >> 5];
  const int64_t m = (int64_t)nw * kNB;
  const int32_t* row = buckets + w * kNB + 4 * lane;
#pragma unroll 8
  for (int r = 0; r < 40; r++) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + r * m));
    s[r][0][lane] = v.x;
    s[r][1][lane] = v.y;
    s[r][2][lane] = v.z;
    s[r][3][lane] = v.w;
  }
  // each lane reads back only what it wrote itself: no barrier
  auto bucket = [&](int i) {
    ge p;
#pragma unroll
    for (int l = 0; l < 10; l++) {
      p.X.v[l] = s[l][i][lane];
      p.Y.v[l] = s[10 + l][i][lane];
      p.Z.v[l] = s[20 + l][i][lane];
      p.T.v[l] = s[30 + l][i][lane];
    }
    return p;
  };
  ge run = bucket(3), tot = run;               // 1. U_s and T_s
#pragma unroll 1
  for (int i = 2; i >= 0; i--) {
    run = ge_add(run, bucket(i));
    tot = ge_add(tot, run);
  }
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {           // 2. V_s
    const ge o = ge_shfl_down(run, d);
    if (lane + d < 32) run = ge_add(run, o);
  }
  if (lane > 0) {                              // 3. Q_s
#pragma unroll 1
    for (int i = 0; i < 2; i++) run = ge_dbl(run);
    tot = ge_add(tot, run);
  }
#pragma unroll 1
  for (int d = 16; d > 0; d >>= 1) {           // 4. sum_s Q_s
    const ge o = ge_shfl_down(tot, d);
    if (lane < d) tot = ge_add(tot, o);
  }
  if (lane == 0) ge_store(out, nw, w, tot);
}

// K5: Horner across windows, replacing
// bulletproof_gadgets_tpu/ops/msm_serial.py:_horner_kernel.  Vector v =
// sum_w 2^(c*w) * ws[v * nwin + w], windows high to low: (nwin - 1) *
// (c + 1) = 279 dependent point operations per vector (248 doublings, 31
// adds), k = 1-11 vectors a launch.  Bound on the H100: that chain's
// latency (the doublings cannot be fewer), ~3 us per operation when one
// thread runs it.  Design: one warp per vector (one per block, so each
// vector has an SM to itself), the accumulator and the vector's window
// sums in shared memory, and each point operation as levels of
// independent field products spread over the warp: ge_dbl is two levels
// of four (the four squarings, then the four products), ge_add three (four
// products, T1 T2 * 2d, four products), by field.cuh's warp_dbl and
// warp_add: every field multiplication is spread over 8 lanes, and a level
// costs two columns, ten shuffles, one carry chain and two warp barriers
// instead of up to four whole fe_muls.  What remains of a level (~0.44 us
// on the H100) is the carry chain (7 dependent 64-bit carries) and the
// barriers' shared-memory round trips.  The column sums, the carry order
// and the sequence of operations are those of fe_mul, ge_dbl and ge_add,
// so the limbs are those of ops/msm_serial.horner_plain.
constexpr int kMaxWin = 32;

struct HornerScratch {
  WarpScratch w;              // the accumulator, a level's operands
  int32_t q[kMaxWin][4][10];  // the vector's window sums
};

__global__ void __launch_bounds__(32)
horner_kernel(const int32_t* __restrict__ ws, int k, int nwin, int c,
              int32_t* __restrict__ out) {
  __shared__ HornerScratch s;
  const int lane = threadIdx.x;
  const int64_t v = blockIdx.x, n = (int64_t)k * nwin;
  for (int t = lane; t < 40 * nwin; t += 32) {  // windows fastest: coalesced
    const int r = t / nwin, w = t % nwin;
    const int32_t x = ws[r * n + v * nwin + w];
    s.q[w][r / 10][r % 10] = x;
    if (w == nwin - 1) s.w.r[r / 10][r % 10] = x;  // acc = the top window
  }
  warp_scratch_init(s.w);
  __syncwarp();
#pragma unroll 1
  for (int w = nwin - 2; w >= 0; w--) {
#pragma unroll 1
    for (int i = 0; i < c; i++) warp_dbl(s.w);
    warp_add(s.w, s.q[w]);
  }
  for (int t = lane; t < 40; t += 32) out[t * k + v] = s.w.r[t / 10][t % 10];
}

// K7: lane i of out = ws[0][i] + ws[1][i] + ... + ws[D-1][i], the window
// sums of D point chunks [D, 4, 10, n] added in chunk order by unified
// additions on field32.cuh's core (the chained adds of the D - 1 launches
// this replaces), written as canonical limbs.  One thread per lane: at the
// chunk combine's 32-352 lanes the launch is the cost, not the adds.
__global__ void __launch_bounds__(kThreads)
point_sum_kernel(const int32_t* __restrict__ ws, int D, int n,
                 int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge8 acc = ge8_from_carried(ge_load(ws, n, i));
  for (int d = 1; d < D; d++)
    acc = ge8_add(acc, ge8_from_carried(ge_load(ws + (int64_t)d * 40 * n,
                                                n, i)));
  ge_store(out, n, i, ge8_to_canonical_limbs(acc));
}

}  // namespace

extern "C" {

int bpg_bucket_accumulate(const void* src, const void* idx, int T, int P,
                          int64_t ident, void* out, void* stream) {
  bucket_accumulate_kernel<false><<<blocks_for(P), kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)idx, T, P, ident, nullptr,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_bucket_accumulate_cont(const void* src, const void* idx, int T,
                               int P, int64_t ident, const void* acc,
                               void* out, void* stream) {
  bucket_accumulate_kernel<true><<<blocks_for(P), kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)idx, T, P, ident,
      (const int32_t*)acc, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K8: g int32 [T, 30, P] (rounds leading, limb-major), replacing
// bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel.
int bpg_bucket_accumulate_cols(const void* g, int64_t T, int64_t P,
                               void* out, void* stream) {
  bucket_accumulate_limbs_kernel<false><<<blocks_for(P), kThreads, 0,
                                          (cudaStream_t)stream>>>(
      (const int32_t*)g, 30 * P, P, T, P, nullptr, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K9: K8 from the carried pool acc, replacing
// bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel_cont.
int bpg_bucket_accumulate_cols_cont(const void* g, int64_t T, int64_t P,
                                    const void* acc, void* out,
                                    void* stream) {
  bucket_accumulate_limbs_kernel<true><<<blocks_for(P), kThreads, 0,
                                         (cudaStream_t)stream>>>(
      (const int32_t*)g, 30 * P, P, T, P, (const int32_t*)acc,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// K10: g int32 [30, T * P] (lane p's round t at column t * P + p),
// replacing bulletproof_gadgets_tpu/ops/msm_serial.py:_bucket_kernel2d.
int bpg_bucket_accumulate_flat(const void* g, int64_t T, int64_t P,
                               void* out, void* stream) {
  bucket_accumulate_limbs_kernel<false><<<blocks_for(P), kThreads, 0,
                                          (cudaStream_t)stream>>>(
      (const int32_t*)g, P, T * P, T, P, nullptr, (int32_t*)out);
  return (int)cudaGetLastError();
}

// G in {1, 2, 4, .., 32} (cudaErrorInvalidValue otherwise)
int bpg_bucket_merge(const void* pool, int P, const void* offs,
                     const void* sub, int M, int G, int lng, void* out,
                     void* stream) {
  if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
  const int64_t warps = 2 * (((int64_t)M + 32 / G - 1) / (32 / G));
  bucket_merge_kernel<<<(int)((warps + kMergeWarps - 1) / kMergeWarps),
                        32 * kMergeWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pool, P, (const int32_t*)offs, (const int32_t*)sub, M,
      G, lng, (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_window_sums(const void* buckets, int nw, int nb, void* out,
                    void* stream) {
  if (nb != kNB) return (int)cudaErrorInvalidValue;  // the staging's size
  window_sums_kernel<<<(nw + kWinPerBlock - 1) / kWinPerBlock,
                       32 * kWinPerBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)buckets, nw, (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_horner(const void* ws, int k, int nwin, int c, void* out,
               void* stream) {
  if (nwin < 1 || nwin > kMaxWin) return (int)cudaErrorInvalidValue;
  horner_kernel<<<k, 32, 0, (cudaStream_t)stream>>>((const int32_t*)ws, k,
                                                    nwin, c, (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_point_sum(const void* ws, int D, int n, void* out, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  point_sum_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ws, D, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
