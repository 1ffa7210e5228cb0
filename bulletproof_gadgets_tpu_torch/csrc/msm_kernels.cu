// The kernels of the serial-bucket MSM (ops/msm_serial.py): the four stages
// of one MSM (K1, K3, K4, K5), the bucket accumulation that carries its
// pool in across round chunks (K2), the lane-wise add that combines the
// window sums of point chunks (K7), and the bucket accumulation of the
// pre-transposed layouts (K8, K9, K10), with a plain C interface for
// ctypes.  Each launcher runs on the given stream, allocates nothing, and
// returns cudaGetLastError() (0 = launched).
//
// Point arrays use the [4, 10, n] int32 layout of field.cuh; source rows
// are int32 [S, 32]: x limbs 0..9, y 10..19, t2d = x*y*2d 20..29, 2 pad.
// Gathered coordinates (K8-K10) hold the same 30 limbs per slot, limb-major:
// limb l of lane p's round t at g[t * round_stride + l * limb_stride + p].
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace bpg;

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

// K1 (kCarry false): lane p accumulates the rows idx[0..T-1, p] by mixed
// addition, from the identity.  K2 (kCarry true): the same T adds, started
// from lane p of acc_in (the pool of the earlier round chunks).
template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_kernel(const int32_t* __restrict__ src,
                         const int32_t* __restrict__ idx, int T, int P,
                         const int32_t* __restrict__ acc_in,
                         int32_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  ge acc = kCarry ? ge_load(acc_in, P, lane) : ge_identity();
  for (int t = 0; t < T; t++) {
    const int64_t row = idx[(int64_t)t * P + lane];
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
    acc = ge_madd(acc, x, y, t2d);
  }
  ge_store(out, P, lane, acc);
}

// K8 (cols, kCarry false), K9 (cols, kCarry true) and K10 (flat): K1's
// mixed adds on coordinates gathered beforehand (ops/msm_serial.gather_cols,
// gather_flat).  Lane p reads limb l of round t at
// g[t * round_stride + l * limb_stride + p]: consecutive lanes read
// consecutive addresses, so each of a round's 30 loads is coalesced across
// the warp (K1 instead reads one scattered 128-byte row per lane).  Bound on
// the H100: the larger of 7 field muls (700 32x32->64 products, ~42 ps at
// the int32 multiply rate) per live slot and 120 bytes of coordinates (~36
// ps at 3.35 TB/s) per slot read once; the two are of one size, so the
// design reads each byte once, coalesced, keeps K1's thread per lane with
// the accumulator in registers for all T rounds, and leaves the random
// access to the gather pass before it.
// Offsets are int64: a flat gather of a large MSM passes 2^31 elements.
template <bool kCarry>
__global__ void __launch_bounds__(kThreads)
bucket_accumulate_limbs_kernel(const int32_t* __restrict__ g,
                               int64_t round_stride, int64_t limb_stride,
                               int64_t T, int64_t P,
                               const int32_t* __restrict__ acc_in,
                               int32_t* __restrict__ out) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P) return;
  ge acc = kCarry ? ge_load(acc_in, P, lane) : ge_identity();
  const int32_t* col = g + lane;
  for (int64_t t = 0; t < T; t++, col += round_stride) {
    const int32_t* q = col;
    fe x, y, t2d;
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) x.v[i] = __ldg(q);
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) y.v[i] = __ldg(q);
#pragma unroll
    for (int i = 0; i < 10; i++, q += limb_stride) t2d.v[i] = __ldg(q);
    acc = ge_madd(acc, x, y, t2d);
  }
  ge_store(out, P, lane, acc);
}

// K3: bucket b sums its lanes offs[b] .. offs[b] + sub[b] - 1 in order.
__global__ void __launch_bounds__(kThreads)
bucket_merge_kernel(const int32_t* __restrict__ pool, int P,
                    const int32_t* __restrict__ offs,
                    const int32_t* __restrict__ sub, int M,
                    int32_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= M) return;
  const int s = sub[b];
  ge acc = ge_identity();
  if (s > 0) {
    const int64_t o = offs[b];
    acc = ge_load(pool, P, o);
    for (int j = 1; j < s; j++) acc = ge_add(acc, ge_load(pool, P, o + j));
  }
  ge_store(out, M, b, acc);
}

// K4: window w = sum_j (j + 1) * S[w * nb + j] by the running sum.
__global__ void __launch_bounds__(kThreads)
window_sums_kernel(const int32_t* __restrict__ buckets, int nw, int nb,
                   int32_t* __restrict__ out) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  const int64_t m = (int64_t)nw * nb;
  ge running = ge_identity();
  ge total = ge_identity();
  for (int j = nb - 1; j >= 0; j--) {
    running = ge_add(running, ge_load(buckets, m, w * nb + j));
    total = ge_add(total, running);
  }
  ge_store(out, nw, w, total);
}

// K5: vector v = sum_w 2^(c*w) * ws[v * nwin + w], windows high to low.
__global__ void __launch_bounds__(kThreads)
horner_kernel(const int32_t* __restrict__ ws, int k, int nwin, int c,
              int32_t* __restrict__ out) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= k) return;
  const int64_t n = (int64_t)k * nwin;
  ge acc = ge_load(ws, n, v * nwin + nwin - 1);
  for (int w = nwin - 2; w >= 0; w--) {
    for (int i = 0; i < c; i++) acc = ge_dbl(acc);
    acc = ge_add(acc, ge_load(ws, n, v * nwin + w));
  }
  ge_store(out, k, v, acc);
}

// K7: lane i of out = p[lane i] + q[lane i] (unified addition).
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                 int n, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge_store(out, n, i, ge_add(ge_load(p, n, i), ge_load(q, n, i)));
}

}  // namespace

extern "C" {

int bpg_bucket_accumulate(const void* src, const void* idx, int T, int P,
                          void* out, void* stream) {
  bucket_accumulate_kernel<false><<<blocks_for(P), kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)idx, T, P, nullptr,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_bucket_accumulate_cont(const void* src, const void* idx, int T,
                               int P, const void* acc, void* out,
                               void* stream) {
  bucket_accumulate_kernel<true><<<blocks_for(P), kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)idx, T, P, (const int32_t*)acc,
      (int32_t*)out);
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

int bpg_bucket_merge(const void* pool, int P, const void* offs,
                     const void* sub, int M, void* out, void* stream) {
  bucket_merge_kernel<<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pool, P, (const int32_t*)offs, (const int32_t*)sub, M,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_window_sums(const void* buckets, int nw, int nb, void* out,
                    void* stream) {
  window_sums_kernel<<<blocks_for(nw), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)buckets, nw, nb, (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_horner(const void* ws, int k, int nwin, int c, void* out,
               void* stream) {
  horner_kernel<<<blocks_for(k), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ws, k, nwin, c, (int32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_point_add(const void* p, const void* q, int n, void* out,
                  void* stream) {
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, (const int32_t*)q, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
