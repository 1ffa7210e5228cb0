// F_p (p = 2^255 - 19) and extended twisted-Edwards point functions shared
// by the kernels of this package (K1, K2, K7, K8-K10 and the compression
// add on field32.cuh's radix-2^32 core instead, and use only the limb
// layout, loads and fe_canonical here).
// Plain-PyTorch twins: ops/fp.py (field) and ops/curve.py (points); both
// compute the same integers, so kernel and plain results agree limb for
// limb.  Every function is inline or static, so each translation unit that
// includes this header gets its own copies and the units link into one
// library without clashes.
//
// Layout: 10 signed int32 limbs, radix 2^25.5 (ref10): limb i weighs 2^S[i],
// S = 0, 26, 51, 77, 102, 128, 153, 179, 204, 230; widths 26, 25, 26, ...
// add/sub do no carry; fe_mul forms the int64 column sums
//   h_k = d_k + 19 * w_k,  d_k = sum_{i+j=k} f_i g_j (2x if i, j odd),
//                          w_k = sum_{i+j=k+10} f_i g_j (2x if i, j odd),
// then one rounding-carry chain in ref10's order.  The limb and int64
// bounds of every op sequence below are proved in tests/test_torch_bounds.py.
#pragma once
#include <stdint.h>

namespace bpg {

struct fe {
  int32_t v[10];
};

struct ge {  // extended coordinates: x = X/Z, y = Y/Z, x*y = T/Z
  fe X, Y, Z, T;
};

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = 0;
  return r;
}

__device__ __forceinline__ fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

// 2d mod p, canonical limbs (ops/fp.D2; checked by tests/test_torch_field.py)
__device__ __forceinline__ fe fe_d2() {
  fe r = {{45281625, 27714825, 36363642, 13898781, 229458, 15978800,
           54557047, 27058993, 29715967, 9444199}};
  return r;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = a.v[i] - b.v[i];
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = -a.v[i];
  return r;
}

// rounding carry of limb i (width w) into limb i + 1 (arithmetic shifts)
#define BPG_CARRY(h, i, w)                                      \
  do {                                                          \
    int64_t c_ = (h[i] + (int64_t(1) << ((w)-1))) >> (w);       \
    h[i] -= c_ * (int64_t(1) << (w));                           \
    h[(i) + 1] += c_;                                           \
  } while (0)

__device__ __forceinline__ fe fe_carry(int64_t h[10]) {
  BPG_CARRY(h, 0, 26);
  BPG_CARRY(h, 4, 26);
  BPG_CARRY(h, 1, 25);
  BPG_CARRY(h, 5, 25);
  BPG_CARRY(h, 2, 26);
  BPG_CARRY(h, 6, 26);
  BPG_CARRY(h, 3, 25);
  BPG_CARRY(h, 7, 25);
  BPG_CARRY(h, 4, 26);
  BPG_CARRY(h, 8, 26);
  {
    int64_t c = (h[9] + (int64_t(1) << 24)) >> 25;  // 2^255 = 19 mod p
    h[9] -= c * (int64_t(1) << 25);
    h[0] += 19 * c;
  }
  BPG_CARRY(h, 0, 26);
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (int32_t)h[i];
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
  int64_t d[10], w[9];
#pragma unroll
  for (int k = 0; k < 10; k++) d[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t fi = f.v[i];
    const int32_t fi2 = 2 * f.v[i];
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int64_t p = (int64_t)(((i & 1) && (j & 1)) ? fi2 : fi) * g.v[j];
      if (i + j < 10)
        d[i + j] += p;
      else
        w[i + j - 10] += p;
    }
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 9; k++) h[k] = d[k] + 19 * w[k];
  h[9] = d[9];
  return fe_carry(h);
}

__device__ __forceinline__ fe fe_sqn(fe x, int n) {
  for (int i = 0; i < n; i++) x = fe_mul(x, x);
  return x;
}

// z^(p-2) = 1/z, the curve25519 chain (ops/curve.inv_fp): 254 squarings
// and 11 multiplies
static __device__ __noinline__ fe fe_inv(const fe& z) {
  const fe z2 = fe_mul(z, z);
  const fe z9 = fe_mul(fe_sqn(z2, 2), z);
  const fe z11 = fe_mul(z9, z2);
  const fe z_5_0 = fe_mul(fe_mul(z11, z11), z9);
  const fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
  const fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
  const fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
  const fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
  const fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
  const fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
  const fe z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
  return fe_mul(fe_sqn(z_250_0, 5), z11);
}

// the unique limbs in [0, 2^w) of the value mod p, for |limb| < 2^28 - 152
// (ops/fp.canonical, op for op)
__device__ __forceinline__ fe fe_canonical(const fe& a) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++)  // + 8p, split limb-wise (ops/fp._BIAS_8P)
    h[i] = a.v[i] + 8 * ((1 << ((i & 1) ? 25 : 26)) - (i == 0 ? 19 : 1));
#pragma unroll
  for (int r = 0; r < 3; r++) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
      const int w = (i & 1) ? 25 : 26;
      const int32_t c = h[i] >> w;
      h[i] &= (1 << w) - 1;
      if (i == 9)
        h[0] += 19 * c;
      else
        h[i + 1] += c;
    }
  }
  int32_t q = (h[0] + 19) >> 26;  // value >= p ?
#pragma unroll
  for (int i = 1; i < 10; i++) q = (h[i] + q) >> ((i & 1) ? 25 : 26);
  h[0] += 19 * q;
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int w = (i & 1) ? 25 : 26;
    const int32_t c = h[i] >> w;
    h[i] &= (1 << w) - 1;
    if (i < 9) h[i + 1] += c;
    r.v[i] = h[i];
  }
  return r;
}

__device__ __forceinline__ ge ge_identity() {
  ge r;
  r.X = fe_zero();
  r.Y = fe_one();
  r.Z = fe_one();
  r.T = fe_zero();
  return r;
}

// unified addition (ops/curve.padd)
__device__ __forceinline__ ge ge_add(const ge& p, const ge& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(p.T, q.T), fe_d2());
  const fe zz = fe_mul(p.Z, q.Z);
  const fe d = fe_add(zz, zz);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// mixed addition of an affine operand with t2d = x*y*2d (ops/curve.madd)
__device__ __forceinline__ ge ge_madd(const ge& p, const fe& x2,
                                      const fe& y2, const fe& t2d) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(y2, x2));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(y2, x2));
  const fe c = fe_mul(p.T, t2d);
  const fe d = fe_add(p.Z, p.Z);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// doubling, dbl-2008-hwcd with a = -1 (ops/curve.dbl)
__device__ __forceinline__ ge ge_dbl(const ge& p) {
  const fe a = fe_mul(p.X, p.X);
  const fe b = fe_mul(p.Y, p.Y);
  const fe zz = fe_mul(p.Z, p.Z);
  const fe c = fe_add(zz, zz);
  const fe s = fe_add(p.X, p.Y);
  const fe xysq = fe_mul(s, s);
  const fe h = fe_add(a, b);
  const fe e = fe_sub(h, xysq), g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// cached form (y - x, y + x, 2z, 2d*t) of an extended point
struct ge_cached {
  fe d, s, z2, t2d;
};

__device__ __forceinline__ ge_cached ge_to_cached(const ge& p) {
  ge_cached c;
  c.d = fe_sub(p.Y, p.X);
  c.s = fe_add(p.Y, p.X);
  c.z2 = fe_add(p.Z, p.Z);
  c.t2d = fe_mul(p.T, fe_d2());
  return c;
}

// extended + cached (ops/curve.padd_cached; 8 muls)
__device__ __forceinline__ ge ge_padd_cached(const ge& p, const ge_cached& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), q.d);
  const fe b = fe_mul(fe_add(p.Y, p.X), q.s);
  const fe c = fe_mul(p.T, q.t2d);
  const fe d = fe_mul(p.Z, q.z2);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c),
           h = fe_add(b, a);
  ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  r.T = fe_mul(e, h);
  return r;
}

// points in the [4, 10, n] int32 layout: coordinate c, limb i of lane j at
// (c * 10 + i) * n + j (consecutive lanes are consecutive addresses)
__device__ __forceinline__ fe fe_load(const int32_t* __restrict__ base,
                                      int64_t n, int64_t j, int c) {
  fe r;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = base[(c * 10 + i) * n + j];
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ base,
                                         int64_t n, int64_t j, int c,
                                         const fe& a) {
#pragma unroll
  for (int i = 0; i < 10; i++) base[(c * 10 + i) * n + j] = a.v[i];
}

__device__ __forceinline__ ge ge_load(const int32_t* __restrict__ base,
                                      int64_t n, int64_t j) {
  ge r;
  r.X = fe_load(base, n, j, 0);
  r.Y = fe_load(base, n, j, 1);
  r.Z = fe_load(base, n, j, 2);
  r.T = fe_load(base, n, j, 3);
  return r;
}

__device__ __forceinline__ void ge_store(int32_t* __restrict__ base,
                                         int64_t n, int64_t j, const ge& p) {
  fe_store(base, n, j, 0, p.X);
  fe_store(base, n, j, 1, p.Y);
  fe_store(base, n, j, 2, p.Z);
  fe_store(base, n, j, 3, p.T);
}

// lane-wise shuffle of a whole point (every lane of the warp takes part)
__device__ __forceinline__ ge ge_shfl_down(const ge& p, int d) {
  ge r;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    r.X.v[i] = __shfl_down_sync(0xffffffffu, p.X.v[i], d);
    r.Y.v[i] = __shfl_down_sync(0xffffffffu, p.Y.v[i], d);
    r.Z.v[i] = __shfl_down_sync(0xffffffffu, p.Z.v[i], d);
    r.T.v[i] = __shfl_down_sync(0xffffffffu, p.T.v[i], d);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Point operations of one point, spread over a whole warp (K5's Horner and
// the top of K6's fold tree).  The point lives in shared memory; each
// operation runs as levels of up to four independent field products, and
// in a level, group p = lane / 8 forms product p: lane q of the group forms
// the int64 column sums h_q and (q < 2) h_q+8 of fe_mul (10 products each),
// lane 0 of the group gathers the ten by shuffles and runs fe_carry on them.
// The column sums, the carry order and the sequence of operations are
// those of fe_mul, ge_dbl and ge_add, so the limbs are theirs.

struct WarpScratch {
  int32_t f[4][10];        // a level's operands
  int32_t g[4][10];
  int32_t r[5][10];        // its products; r[0..3] = the accumulator
  int32_t d2[10];
};

// 2d into s.d2 (each lane < 10 writes one limb; warp_products syncs)
__device__ __forceinline__ void warp_scratch_init(WarpScratch& s) {
  const int lane = threadIdx.x & 31;
  const fe d2 = fe_d2();
#pragma unroll
  for (int i = 0; i < 10; i++)
    if (lane == i) s.d2[i] = d2.v[i];
}

// column k of f * g as fe_mul forms it: h_k = d_k + 19 w_k
__device__ __forceinline__ int64_t fe_column(const int32_t* f,
                                             const int32_t* g, int k) {
  int64_t d = 0, w = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const bool wrap = i > k;
    const int j = wrap ? k - i + 10 : k - i;
    const int32_t fi = ((i & 1) && (j & 1)) ? 2 * f[i] : f[i];
    const int64_t p = (int64_t)fi * g[j];
    if (wrap)
      w += p;
    else
      d += p;
  }
  return d + 19 * w;
}

// One level of n <= 4 independent products: s.r[out + p] = s.f[p] * s.g[p]
// (the operands written before the call; the products readable after it).
// Lanes q >= 2 form their own column twice, so that every lane runs the
// same straight-line code.
__device__ __forceinline__ void warp_products(WarpScratch& s, int n,
                                              int out) {
  const int lane = threadIdx.x & 31, p = lane >> 3, q = lane & 7;
  __syncwarp();
  int64_t a = 0, b = 0;
  if (p < n) {
    a = fe_column(s.f[p], s.g[p], q);
    b = fe_column(s.f[p], s.g[p], q < 2 ? q + 8 : q);
  }
  int64_t h[10];
  const int g0 = lane & ~7;
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = __shfl_sync(0xffffffffu, a, g0 + i);
  h[8] = __shfl_sync(0xffffffffu, b, g0);
  h[9] = __shfl_sync(0xffffffffu, b, g0 + 1);
  if (p < n && q == 0) {
    const fe r = fe_carry(h);
#pragma unroll
    for (int i = 0; i < 10; i++) s.r[out + p][i] = r.v[i];
  }
  __syncwarp();
}

// the accumulator s.r[0..3] doubled, as ge_dbl
__device__ __forceinline__ void warp_dbl(WarpScratch& s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = lane; t < 40; t += 32) {        // X^2, Y^2, Z^2, (X + Y)^2
    const int p = t / 10, i = t % 10;
    const int32_t v = p < 3 ? s.r[p][i] : s.r[0][i] + s.r[1][i];
    s.f[p][i] = v;
    s.g[p][i] = v;
  }
  warp_products(s, 4, 0);                      // a, b, zz, xysq
#pragma unroll
  for (int t = lane; t < 40; t += 32) {        // e f, g h, f g, e h
    const int p = t / 10, i = t % 10;
    const int32_t a = s.r[0][i], b = s.r[1][i], zz = s.r[2][i];
    const int32_t h = a + b, e = h - s.r[3][i], g = a - b, f = (zz + zz) + g;
    s.f[p][i] = p == 0 ? e : p == 1 ? g : p == 2 ? f : e;
    s.g[p][i] = p == 0 ? f : p == 1 ? h : p == 2 ? g : h;
  }
  warp_products(s, 4, 0);                      // X, Y, Z, T
}

// the accumulator s.r[0..3] plus the point q (shared memory, [4][10]), as
// ge_add(acc, q)
__device__ __forceinline__ void warp_add(WarpScratch& s,
                                         const int32_t (*q)[10]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = lane; t < 40; t += 32) {
    const int p = t / 10, i = t % 10;
    const int32_t x1 = s.r[0][i], y1 = s.r[1][i], x2 = q[0][i], y2 = q[1][i];
    s.f[p][i] = p == 0 ? y1 - x1 : p == 1 ? y1 + x1 : s.r[p == 2 ? 3 : 2][i];
    s.g[p][i] = p == 0 ? y2 - x2 : p == 1 ? y2 + x2 : q[p == 2 ? 3 : 2][i];
  }
  warp_products(s, 4, 0);                      // a, b, T1 T2, Z1 Z2
  if (lane < 10) {
    s.f[0][lane] = s.r[2][lane];
    s.g[0][lane] = s.d2[lane];
  }
  warp_products(s, 1, 4);                      // c = T1 T2 * 2d
#pragma unroll
  for (int t = lane; t < 40; t += 32) {        // e f, g h, f g, e h
    const int p = t / 10, i = t % 10;
    const int32_t a = s.r[0][i], b = s.r[1][i], zz = s.r[3][i], c = s.r[4][i];
    const int32_t d = zz + zz, e = b - a, f = d - c, g = d + c, h = b + a;
    s.f[p][i] = p == 0 ? e : p == 1 ? g : p == 2 ? f : e;
    s.g[p][i] = p == 0 ? f : p == 1 ? h : p == 2 ? g : h;
  }
  warp_products(s, 4, 0);                      // X, Y, Z, T
}

}  // namespace bpg
