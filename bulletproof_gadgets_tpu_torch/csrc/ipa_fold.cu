// K6, the IPA table-fold ladder (ops/ipa_fold.py:ladder_fold), with a plain C
// interface for ctypes.  The launcher runs on the given stream, allocates
// nothing, and returns cudaGetLastError() (0 = launched).
//
// Output lane i folds K = 2^d source points into one:
//   O_i = sum_k s_ki * P[base[k, i]],  s_ki = sum_w (dig[w*K + k, i] - 8) 16^w
// Source and output rows are int32 [*, 32]: x limbs 0..9, y 10..19,
// t2d = 2d*x*y 20..29, 2 pad.  The scratch [K*8, 4, 10, n] holds each lane's
// cached multiples 1P..8P; only the lane's own thread writes and reads them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace bpg;

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int64_t row, fe& x, fe& y, fe& t2d) {
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
#pragma unroll
  for (int i = 0; i < 10; i++) {
    x.v[i] = w[i];
    y.v[i] = w[10 + i];
    t2d.v[i] = w[20 + i];
  }
}

// cached point `slot` of lane j in the [slots, 4, 10, n] scratch
__device__ __forceinline__ void cached_store(int32_t* __restrict__ s,
                                             int64_t n, int64_t j, int slot,
                                             const ge_cached& c) {
  int32_t* b = s + (int64_t)slot * 40 * n;
  fe_store(b, n, j, 0, c.d);
  fe_store(b, n, j, 1, c.s);
  fe_store(b, n, j, 2, c.z2);
  fe_store(b, n, j, 3, c.t2d);
}

__device__ __forceinline__ ge_cached cached_load(const int32_t* __restrict__ s,
                                                 int64_t n, int64_t j,
                                                 int slot) {
  const int32_t* b = s + (int64_t)slot * 40 * n;
  ge_cached c;
  c.d = fe_load(b, n, j, 0);
  c.s = fe_load(b, n, j, 1);
  c.z2 = fe_load(b, n, j, 2);
  c.t2d = fe_load(b, n, j, 3);
  return c;
}

__device__ __forceinline__ void row_store(int32_t* __restrict__ out,
                                          const fe& x, const fe& y,
                                          const fe& t2d) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    out[i] = x.v[i];
    out[10 + i] = y.v[i];
    out[20 + i] = t2d.v[i];
  }
  out[30] = 0;
  out[31] = 0;
}

__global__ void __launch_bounds__(kThreads)
ladder_fold_kernel(const int32_t* __restrict__ src,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ dig, int K, int n,
                   int32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // 1. the cached multiples 1P..8P of each term's point (ops/ipa_fold
  //    _multiples: doublings, and mixed adds of the affine row)
  for (int k = 0; k < K; k++) {
    fe x, y, t2d;
    load_row(src, base[(int64_t)k * n + i], x, y, t2d);
    ge p1;
    p1.X = x;
    p1.Y = y;
    p1.Z = fe_one();
    p1.T = fe_zero();  // unused by ge_dbl
    ge_cached c1;
    c1.d = fe_sub(y, x);
    c1.s = fe_add(y, x);
    c1.z2 = fe_add(p1.Z, p1.Z);
    c1.t2d = t2d;
    cached_store(scratch, n, i, k * 8 + 0, c1);
    const ge p2 = ge_dbl(p1);
    cached_store(scratch, n, i, k * 8 + 1, ge_to_cached(p2));
    const ge p3 = ge_madd(p2, x, y, t2d);
    cached_store(scratch, n, i, k * 8 + 2, ge_to_cached(p3));
    const ge p4 = ge_dbl(p2);
    cached_store(scratch, n, i, k * 8 + 3, ge_to_cached(p4));
    cached_store(scratch, n, i, k * 8 + 4,
                 ge_to_cached(ge_madd(p4, x, y, t2d)));
    const ge p6 = ge_dbl(p3);
    cached_store(scratch, n, i, k * 8 + 5, ge_to_cached(p6));
    cached_store(scratch, n, i, k * 8 + 6,
                 ge_to_cached(ge_madd(p6, x, y, t2d)));
    cached_store(scratch, n, i, k * 8 + 7, ge_to_cached(ge_dbl(p4)));
  }

  // 2. the ladder: windows high to low, 4 doublings, then one signed
  //    select-and-add per term (digit 0 adds the identity (1, 1, 2, 0))
  ge acc = ge_identity();
  for (int w = 63; w >= 0; w--) {
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    for (int k = 0; k < K; k++) {
      const int e = dig[((int64_t)w * K + k) * n + i];
      ge_cached c;
      if (e == 8) {
        c.d = fe_one();
        c.s = fe_one();
        c.z2 = fe_add(c.d, c.d);
        c.t2d = fe_zero();
      } else {
        const bool neg = e < 8;
        c = cached_load(scratch, n, i, k * 8 + (neg ? 8 - e : e - 8) - 1);
        if (neg) {
          const fe d = c.d;
          c.d = c.s;
          c.s = d;
          c.t2d = fe_neg(c.t2d);
        }
      }
      acc = ge_padd_cached(acc, c);
    }
  }

  // 3. affine, canonical rows of O_i and -O_i (ops/ipa_fold.affine_rows)
  const fe zinv = fe_inv(acc.Z);
  const fe ax = fe_mul(acc.X, zinv);
  const fe ay = fe_mul(acc.Y, zinv);
  const fe at2d = fe_mul(fe_mul(ax, ay), fe_d2());
  const fe cy = fe_canonical(ay);
  row_store(out + i * 32, fe_canonical(ax), cy, fe_canonical(at2d));
  row_store(out + ((int64_t)n + i) * 32, fe_canonical(fe_neg(ax)), cy,
            fe_canonical(fe_neg(at2d)));
}

}  // namespace

extern "C" {

int bpg_ladder_fold(const void* src, const void* base, const void* dig, int K,
                    int n, void* scratch, void* out, void* stream) {
  ladder_fold_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)base, (const int32_t*)dig, K, n,
      (int32_t*)scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
