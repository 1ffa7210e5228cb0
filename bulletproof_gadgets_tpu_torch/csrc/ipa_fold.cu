// K6, the IPA table-fold ladder (ops/ipa_fold.py:ladder_fold), replacing
// bulletproof_gadgets_tpu/ops/ipa_fold.py:_ladder_kernel, with a plain C
// interface for ctypes.  The launcher runs on the given stream, allocates
// nothing, and returns cudaGetLastError() (0 = launched).
//
// Output i folds K = 2^d source points into one:
//   O_i = sum_k s_ki * P[base[k, i]],  s_ki = sum_w (dig[w*K + k, i] - 8) 16^w
// Source and output rows are int32 [*, 32]: x limbs 0..9, y 10..19,
// t2d = 2d*x*y 20..29, 2 pad.
//
// Bound on the H100: one output's Straus ladder is a chain of ~1,410 point
// operations (K * 7 for the multiples, 64 x (4 doublings + K adds), the Z
// inversion) if one thread runs it, and a fold has only 2,048 (example) to
// 8,192 (merkle32) outputs, so that chain, not the card's multiply rate,
// bounds it.  Design: one warp per output (one per block), the work split
// by windows:
//   1. lane k < K forms its term's cached multiples 1P..8P (7 operations)
//      into shared memory, laid out [k][limb row][multiple] with a term
//      stride of 8 * 40 + 1 words, so that both these writes and the
//      digit-selected reads below are free of bank conflicts;
//   2. lane j sums windows 2j+1 and 2j over all K terms into its partial
//      P_j (K adds, 4 doublings, K adds: 36 operations at K = 16);
//   3. O = sum_j 2^(8j) P_j by Horner, P_31 down to P_0 with 8 doublings
//      between adds (248 doublings, 31 adds), each operation spread over
//      the whole warp (field.cuh warp_dbl / warp_add: each field product
//      over 8 lanes);
//   4. the warp inverts Z (fe_inv's chain, each product over 8 lanes),
//      lane 0 writes the canonical rows of O_i and -O_i.
// A point operation of one lane costs the warp as much issue as one of 32
// lanes (~4.5 us on the H100, set by the 64-bit multiply rate), so the
// join of the lanes' partials and the inversion run warp-wide, where a
// doubling costs ~0.9 us and a few hundred cycles of issue, instead of in
// single lanes.  The longest chain is 7 + 36 one-lane operations, 279
// warp-wide ones and 265 warp-wide products (from ~1,410 operations and
// the inversion in one thread); the work is 1.11x the one-thread ladder's
// field muls (the join's 248 doublings).  Outputs are canonical affine
// rows, unique per point, so any order of adds gives the bytes of
// ladder_fold_plain (which keeps the one-thread ladder's order).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using namespace bpg;

namespace {

constexpr int kMaxTerms = 32;             // d <= 5: the shared memory below
constexpr int kTermStride = 8 * 40 + 1;   // words per term's 8 multiples

// dynamic shared memory: the multiples [K][kTermStride], the lanes'
// partials [32][4][10], then the output's digits
__host__ __device__ constexpr int fold_words(int K) {
  return K * kTermStride + 32 * 40;
}

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

// multiple m (0..7: 1P..8P) of a term, at limb row r (d, s, z2, t2d)
__device__ __forceinline__ void mult_store(int32_t* t, int m,
                                           const ge_cached& c) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    t[i * 8 + m] = c.d.v[i];
    t[(10 + i) * 8 + m] = c.s.v[i];
    t[(20 + i) * 8 + m] = c.z2.v[i];
    t[(30 + i) * 8 + m] = c.t2d.v[i];
  }
}

// coordinate c (0: y - x, 1: y + x, 2: 2z, 3: 2d*t) of the cached operand
// of window digit e (0..15, signed digit e - 8): of the multiple |e - 8|,
// negated for e < 8 (y - x and y + x swap, 2d*t changes sign), of the
// identity (1, 1, 2, 0) for e = 8
__device__ __forceinline__ fe mult_coord(const int32_t* t, int c, int e) {
  const int a = e < 8 ? 8 - e : e - 8;
  const int m = a == 0 ? 0 : a - 1;
  const bool neg = e < 8;
  const int row = neg && c < 2 ? c ^ 1 : c;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t v = t[(row * 10 + i) * 8 + m];
    const int32_t id = i > 0 || c == 3 ? 0 : c == 2 ? 2 : 1;
    r.v[i] = a == 0 ? id : neg && c == 3 ? -v : v;
  }
  return r;
}

// acc + the cached operand of digit e (ge_padd_cached)
__device__ __forceinline__ ge fold_add(const ge& p, const int32_t* t, int e) {
  ge_cached q;
  q.d = mult_coord(t, 0, e);
  q.s = mult_coord(t, 1, e);
  q.z2 = mult_coord(t, 2, e);
  q.t2d = mult_coord(t, 3, e);
  return ge_padd_cached(p, q);
}

// dst = a * b (rows of 10 limbs in shared memory), the product spread over
// 8 lanes as in warp_products; lane l < 10 moves limb l in and out, so dst
// may be a or b
__device__ __forceinline__ void warp_mul(WarpScratch& s, const int32_t* a,
                                         const int32_t* b, int32_t* dst) {
  const int lane = threadIdx.x & 31;
  if (lane < 10) {
    s.f[0][lane] = a[lane];
    s.g[0][lane] = b[lane];
  }
  warp_products(s, 1, 4);
  if (lane < 10) dst[lane] = s.r[4][lane];
}

__device__ __forceinline__ void warp_sqn(WarpScratch& s, int32_t* x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) warp_mul(s, x, x, x);
}

// v[1] = 1 / v[0], fe_inv's chain (254 squarings, 11 multiplies) warp-wide;
// v[2..8] are work rows
__device__ __forceinline__ void warp_inv(WarpScratch& s, int32_t (*v)[10]) {
  int32_t *z = v[0], *out = v[1], *z2 = v[2], *z9 = v[3], *z11 = v[4],
          *z5 = v[5], *z10 = v[6], *z50 = v[7], *t = v[8];
  warp_mul(s, z, z, z2);
  warp_mul(s, z2, z2, t);
  warp_sqn(s, t, 1);
  warp_mul(s, t, z, z9);
  warp_mul(s, z9, z2, z11);
  warp_mul(s, z11, z11, t);
  warp_mul(s, t, z9, z5);                      // z^(2^5 - 1)
  warp_mul(s, z5, z5, t);
  warp_sqn(s, t, 4);
  warp_mul(s, t, z5, z10);                     // z^(2^10 - 1)
  warp_mul(s, z10, z10, t);
  warp_sqn(s, t, 9);
  warp_mul(s, t, z10, out);                    // z^(2^20 - 1)
  warp_mul(s, out, out, t);
  warp_sqn(s, t, 19);
  warp_mul(s, t, out, t);                      // z^(2^40 - 1)
  warp_sqn(s, t, 10);
  warp_mul(s, t, z10, z50);                    // z^(2^50 - 1)
  warp_mul(s, z50, z50, t);
  warp_sqn(s, t, 49);
  warp_mul(s, t, z50, out);                    // z^(2^100 - 1)
  warp_mul(s, out, out, t);
  warp_sqn(s, t, 99);
  warp_mul(s, t, out, t);                      // z^(2^200 - 1)
  warp_sqn(s, t, 50);
  warp_mul(s, t, z50, t);                      // z^(2^250 - 1)
  warp_sqn(s, t, 5);
  warp_mul(s, t, z11, out);                    // z^(2^255 - 21)
}

__device__ __forceinline__ void point_to_smem(int32_t (*p)[10], const ge& q) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    p[0][i] = q.X.v[i];
    p[1][i] = q.Y.v[i];
    p[2][i] = q.Z.v[i];
    p[3][i] = q.T.v[i];
  }
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

// 1. the cached multiples 1P..8P of the point in row `row` of src into
//    the term's words t (ops/ipa_fold._multiples: doublings, and mixed adds of
//    the affine row)
__device__ __forceinline__ void form_multiples(
    const int32_t* __restrict__ src, int64_t row, int32_t* t) {
  fe x, y, t2d;
  load_row(src, row, x, y, t2d);
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
  mult_store(t, 0, c1);
  const ge p2 = ge_dbl(p1);
  mult_store(t, 1, ge_to_cached(p2));
  const ge p3 = ge_madd(p2, x, y, t2d);
  mult_store(t, 2, ge_to_cached(p3));
  const ge p4 = ge_dbl(p2);
  mult_store(t, 3, ge_to_cached(p4));
  mult_store(t, 4, ge_to_cached(ge_madd(p4, x, y, t2d)));
  const ge p6 = ge_dbl(p3);
  mult_store(t, 5, ge_to_cached(p6));
  mult_store(t, 6, ge_to_cached(ge_madd(p6, x, y, t2d)));
  mult_store(t, 7, ge_to_cached(ge_dbl(p4)));
}

// 2. the partial of windows hi and hi - 1 over the K terms (digits e[0..K)
//    of window hi, then of hi - 1), Straus, into p
__device__ __forceinline__ void lane_partial(const int32_t* mult,
                                             const uint8_t* e, int K,
                                             int32_t (*p)[10]) {
  ge acc = ge_identity();
#pragma unroll 1
  for (int k = 0; k < K; k++)
    acc = fold_add(acc, mult + k * kTermStride, e[K + k]);
#pragma unroll 1
  for (int r = 0; r < 4; r++) acc = ge_dbl(acc);
#pragma unroll 1
  for (int k = 0; k < K; k++)
    acc = fold_add(acc, mult + k * kTermStride, e[k]);
  point_to_smem(p, acc);
}

// 3. s.r = sum_j 2^(8j) P_j (the partials p[j]) by Horner from P_31,
//    warp-wide
__device__ __forceinline__ void warp_horner(WarpScratch& s,
                                            int32_t (*p)[4][10]) {
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < 40; t += 32)
    s.r[t / 10][t % 10] = p[31][t / 10][t % 10];
  __syncwarp();
#pragma unroll 1
  for (int j = 30; j >= 0; j--) {
#pragma unroll 1
    for (int r = 0; r < 8; r++) warp_dbl(s);
    warp_add(s, p[j]);
  }
}

// 4. the canonical rows of O = (X / Z, Y / Z) and -O into out[0], out[n]
__device__ __forceinline__ void affine_rows(int32_t* __restrict__ out,
                                            int64_t n, const int32_t (*r)[10],
                                            const int32_t* zinv) {
  fe X, Y, zi;
#pragma unroll
  for (int l = 0; l < 10; l++) {
    X.v[l] = r[0][l];
    Y.v[l] = r[1][l];
    zi.v[l] = zinv[l];
  }
  const fe ax = fe_mul(X, zi);
  const fe ay = fe_mul(Y, zi);
  const fe at2d = fe_mul(fe_mul(ax, ay), fe_d2());
  const fe cy = fe_canonical(ay);
  row_store(out, fe_canonical(ax), cy, fe_canonical(at2d));
  row_store(out + n * 32, fe_canonical(fe_neg(ax)), cy,
            fe_canonical(fe_neg(at2d)));
}

// (32, 1): with at least one block per SM stated, ptxas keeps the lane
// phase in the 255 registers a thread may have; with (32) alone it spilled
// ~56 bytes (nvcc -Xptxas -v, CUDA 12.8)
__global__ void __launch_bounds__(32, 1)
ladder_fold_kernel(const int32_t* __restrict__ src,
                   const int32_t* __restrict__ base,
                   const int32_t* __restrict__ dig, int K, int n,
                   int32_t* __restrict__ out) {
  __shared__ WarpScratch s;                  // step 3's accumulator
  extern __shared__ int32_t mult[];          // see fold_words
  int32_t(*part)[4][10] =
      reinterpret_cast<int32_t(*)[4][10]>(mult + K * kTermStride);
  uint8_t* sdig = reinterpret_cast<uint8_t*>(mult + fold_words(K));
  const int lane = threadIdx.x;
  const int64_t i = blockIdx.x;

  // the output's 64 * K window digits
  for (int t = lane; t < 64 * K; t += 32)
    sdig[t] = (uint8_t)__ldg(dig + (int64_t)t * n + i);
  // 1. the multiples, lane k for term k
  for (int k = lane; k < K; k += 32)
    form_multiples(src, base[(int64_t)k * n + i], mult + k * kTermStride);
  warp_scratch_init(s);
  __syncwarp();

  // 2. lane j: P_j = windows 2j+1 and 2j
  lane_partial(mult, sdig + 2 * lane * K, K, part[lane]);
  __syncwarp();

  // 3. O = sum_j 2^(8j) P_j, warp-wide
  warp_horner(s, part);

  // 4. 1 / Z warp-wide (in the multiples' words), then lane 0 writes the
  //    affine, canonical rows of O_i and -O_i (ops/ipa_fold.affine_rows)
  int32_t(*v)[10] = reinterpret_cast<int32_t(*)[10]>(mult);
  if (lane < 10) v[0][lane] = s.r[2][lane];
  warp_inv(s, v);
  __syncwarp();
  if (lane == 0) affine_rows(out + i * 32, n, s.r, v[1]);
}

}  // namespace

extern "C" {

// K in 1..kMaxTerms (cudaErrorInvalidValue otherwise: the shared memory is
// sized for at most kMaxTerms terms)
int bpg_ladder_fold(const void* src, const void* base, const void* dig, int K,
                    int n, void* out, void* stream) {
  if (K < 1 || K > kMaxTerms) return (int)cudaErrorInvalidValue;
  ladder_fold_kernel<<<n, 32, (size_t)fold_words(K) * 4 + 64 * K,
                       (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)base, (const int32_t*)dig, K, n,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
