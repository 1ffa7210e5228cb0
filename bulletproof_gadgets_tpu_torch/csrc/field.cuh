// F_p (p = 2^255 - 19) and extended twisted-Edwards point functions shared
// by every kernel of this package.  Plain-PyTorch twins: ops/fp.py (field)
// and ops/curve.py (points); both compute the same integers, so kernel and
// plain results agree limb for limb.
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

}  // namespace bpg
