// F_l (l = 2^252 + 27742317777372353535851937790883648493, the Ristretto255
// group order) for the transcript kernel (transcript.cu): Montgomery form
// over 8 x 32-bit words with R8 = 2^256, the IPA challenge's reduction and
// inversion (Bernstein-Yang divsteps, no chain of Montgomery products:
// fl8_inv below), and the conversion to ops/fl.py's rows (10 limbs of 26
// bits, Montgomery R = 2^260), which the device fold consumes.
//
// fl8_mont_mul is word-serial Montgomery multiplication (CIOS) with 64-bit
// intermediates: each a_j * b_i + t_j + carry < 2^64.  With a < l and
// b < 2^256 the result before its one conditional subtraction is
// < (l * 2^256 + 2^256 * l) / 2^256 = 2l < 2^254, so nine words suffice and
// the output is canonical (< l).  Every operand below is canonical or a
// 32-byte string (< 2^256) multiplied by a canonical constant.
// Plain version: ops/ristretto_device.py (challenge_limbs, to_mont_dev,
// inv_mont) on ops/fl.py, which compute the same canonical values (the
// inverse as u^(l-2)).
#pragma once
#include <stdint.h>

namespace bpg {

struct fl8 {
  uint32_t w[8];
};

// l, -l^-1 mod 2^32, and the constants of the conversions (all < l):
// 2^512, 2^768, 2^256 and 2^260 mod l (checked against ops/fl by
// tests/test_torch_ristretto_device.py)
#define BPG_FL8(a, b, c, d, e, f, g, h) {{a, b, c, d, e, f, g, h}}
__device__ __forceinline__ fl8 fl8_l() {
  fl8 r = BPG_FL8(0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u,
                  0u, 0u, 0x10000000u);
  return r;
}
constexpr uint32_t kFlLPrime = 0x12547e1bu;
__device__ __forceinline__ fl8 fl8_r2() {
  fl8 r = BPG_FL8(0x449c0f01u, 0xa40611e3u, 0x68859347u, 0xd00e1ba7u,
                  0x17f5be65u, 0xceec73d2u, 0x7c309a3du, 0x0399411bu);
  return r;
}
__device__ __forceinline__ fl8 fl8_r3() {
  fl8 r = BPG_FL8(0x7b83a2dbu, 0x2a9e4968u, 0xaef7f3ecu, 0x278324e6u,
                  0x04ec5b65u, 0x8065dc6cu, 0x3599cec7u, 0x0e530b77u);
  return r;
}
__device__ __forceinline__ fl8 fl8_one_mont() {  // 2^256 mod l
  fl8 r = BPG_FL8(0x8d98951du, 0xd6ec3174u, 0x737dcf70u, 0xc6ef5bf4u,
                  0xfffffffeu, 0xffffffffu, 0xffffffffu, 0x0fffffffu);
  return r;
}
__device__ __forceinline__ fl8 fl8_r260() {  // 2^260 mod l
  fl8 r = BPG_FL8(0x6721e6edu, 0x45af48bdu, 0xab5ac67eu, 0x35e51b3bu,
                  0xffffffebu, 0xffffffffu, 0xffffffffu, 0x0fffffffu);
  return r;
}
#undef BPG_FL8

// a - l if a >= l, else a (a < 2^256)
__device__ __forceinline__ fl8 fl8_reduce_once(const fl8& a) {
  const fl8 l = fl8_l();
  fl8 d;
  int64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const int64_t s = (int64_t)a.w[j] - l.w[j] + borrow;
    d.w[j] = (uint32_t)s;
    borrow = s >> 32;                    // 0 or -1
  }
  return borrow ? a : d;
}

// a * b / 2^256 mod l, canonical; a < l, b < 2^256 (or the other way)
__device__ __forceinline__ fl8 fl8_mont_mul(const fl8& a, const fl8& b) {
  const fl8 l = fl8_l();
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kFlLPrime;     // t + m*l = 0 mod 2^32
    c = ((uint64_t)m * l.w[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * l.w[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  fl8 r;                                     // < 2l: t[8] is 0
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = t[j];
  return fl8_reduce_once(r);
}

// (a + b) mod l for canonical a, b (the sum < 2l < 2^254)
__device__ __forceinline__ fl8 fl8_add(const fl8& a, const fl8& b) {
  fl8 r;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (uint64_t)a.w[j] + b.w[j];
    r.w[j] = (uint32_t)c;
    c >>= 32;
  }
  return fl8_reduce_once(r);
}

// 64 little-endian bytes -> their value mod l in Montgomery form (x * 2^256
// mod l), Scalar::from_bytes_mod_order_wide's value: with lo and hi the two
// 32-byte halves, lo * 2^512 / 2^256 + hi * 2^768 / 2^256 = (lo + 2^256
// hi) * 2^256
__device__ __forceinline__ fl8 fl8_from_wide_mont(const uint8_t* b) {
  fl8 lo, hi;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    lo.w[j] = (uint32_t)b[4 * j] | ((uint32_t)b[4 * j + 1] << 8) |
              ((uint32_t)b[4 * j + 2] << 16) | ((uint32_t)b[4 * j + 3] << 24);
    hi.w[j] = (uint32_t)b[32 + 4 * j] | ((uint32_t)b[33 + 4 * j] << 8) |
              ((uint32_t)b[34 + 4 * j] << 16) |
              ((uint32_t)b[35 + 4 * j] << 24);
  }
  return fl8_add(fl8_mont_mul(fl8_r2(), lo), fl8_mont_mul(fl8_r3(), hi));
}

// ---------------------------------------------------------------------------
// The inversion: Bernstein-Yang divsteps (safegcd), variable time, in
// batches of 30 on 32-bit words, as libsecp256k1's modinv32_var runs them.
// It replaces x^(l-2) by a chain of Montgomery products: no product of two
// field values at all, only 32 x 32 -> 64 products of a value's limbs by
// the batch's 2 x 2 matrix (entries of at most 2^30).  Variable time is
// acceptable here: x is the IPA challenge, which the verifier recomputes
// from public data (the transcript), so its running time leaks nothing.
//
// Values are signed-30 numbers: nine int32 limbs, value sum v[i] 2^(30 i),
// limbs 0..7 in [0, 2^30) after each update and limb 8 signed.  f, g start
// at l, x and d, e at 0, 1, with d x = f and e x = g (mod l) throughout.
// Each batch takes 30 divsteps on the low words of f and g alone (they
// depend on nothing else) and returns the matrix t scaled by 2^30; then
// (f, g) <- t (f, g) / 2^30 exactly and (d, e) <- t (d, e) / 2^30 mod l,
// the division made exact by adding a multiple of l that clears the low
// 30 bits.  When g reaches 0, f = +-1 and x^-1 = +-d.  The inverse of 0 is
// 0, as x^(l-2) gives: g = 0 from the start, so d stays 0.

struct s30 {
  int32_t v[9];
};

constexpr int32_t kM30 = 0x3fffffff;
constexpr uint32_t kFlLInv30 = 0x2dab81e5u;  // l^-1 mod 2^30

__device__ __forceinline__ s30 s30_l() {
  s30 r = {{0x1cf5d3ed, 0x20498c69, 0x2f79cd65, 0x37be77a8, 0x14, 0, 0, 0,
            0x1000}};
  return r;
}

// x < 2^256 -> its signed-30 limbs: limb i is bits 30 i .. 30 i + 29
__device__ __forceinline__ s30 s30_from_fl8(const fl8& x) {
  s30 r;
  r.v[0] = (int32_t)(x.w[0] & kM30);
#pragma unroll
  for (int i = 1; i < 8; i++)
    r.v[i] = (int32_t)(((x.w[i - 1] >> (32 - 2 * i)) | (x.w[i] << (2 * i))) &
                       kM30);
  r.v[8] = (int32_t)(x.w[7] >> 16);
  return r;
}

// a value in [0, 2^256) with limbs 0..7 in [0, 2^30) -> its words
__device__ __forceinline__ fl8 s30_to_fl8(const s30& a) {
  fl8 r;
#pragma unroll
  for (int j = 0; j < 8; j++)
    r.w[j] = ((uint32_t)a.v[j] >> (2 * j)) |
             ((uint32_t)a.v[j + 1] << (30 - 2 * j));
  return r;
}

// limbs 0..7 back into [0, 2^30), their carries into limb 8 (signed)
__device__ __forceinline__ void s30_carry(s30& a) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    a.v[i + 1] += a.v[i] >> 30;
    a.v[i] &= kM30;
  }
}

// a + s l (s = 1 or -1) and -a, carried
__device__ __forceinline__ void s30_add_l(s30& a, int32_t s) {
  const s30 l = s30_l();
#pragma unroll
  for (int i = 0; i < 9; i++) a.v[i] += s * l.v[i];
  s30_carry(a);
}

__device__ __forceinline__ void s30_neg(s30& a) {
#pragma unroll
  for (int i = 0; i < 9; i++) a.v[i] = -a.v[i];
  s30_carry(a);
}

__device__ __forceinline__ int ctz32(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __clz(__brev(x));
#else
  return __builtin_ctz(x);
#endif
}

// f^-1 mod 2^32 for odd f: (3 f) ^ 2 is right mod 2^5, and each Newton
// step doubles that (5, 10, 20, 40 bits)
__device__ __forceinline__ uint32_t inv_mod32(uint32_t f) {
  uint32_t x = (3 * f) ^ 2;
  x *= 2 - f * x;
  x *= 2 - f * x;
  x *= 2 - f * x;
  return x;
}

// The batch's matrix [[u, v], [q, r]], scaled by 2^30: after the batch
// f' = (u f + v g) / 2^30 and g' = (q f + r g) / 2^30, with |u| + |v| and
// |q| + |r| at most 2^30.
struct s30_trans {
  int32_t u, v, q, r;
};

// 30 divsteps on the low words f0, g0 (f0 odd) from eta (= -delta), the
// new eta returned.  A run of g's zero bits is one shift; with g odd and
// eta >= 0 the next min(eta + 1, remaining) divsteps add f or not and
// halve, which together add the multiple w = -g / f (mod 2^k) of f that
// clears g's low k bits (f's inverse mod 2^32 is kept from the last swap);
// with eta < 0, (f, g) <- (g, -f) first.  The invariants u f0 + v g0 =
// f 2^(30 - i) and q f0 + r g0 = g 2^(30 - i) hold mod 2^32.
__device__ __forceinline__ int divsteps_30(int eta, uint32_t f0, uint32_t g0,
                                           s30_trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
  uint32_t finv = 0u - inv_mod32(f);
  int i = 30;
  for (;;) {
    const int zeros = ctz32(g | (0xffffffffu << i));
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {
      uint32_t tmp;
      eta = -eta;
      tmp = f; f = g; g = 0u - tmp;
      tmp = u; u = q; q = 0u - tmp;
      tmp = v; v = r; r = 0u - tmp;
      finv = 0u - inv_mod32(f);
    }
    const int limit = eta + 1 < i ? eta + 1 : i;
    const uint32_t w = (g * finv) & (0xffffffffu >> (32 - limit));
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return eta;
}

// (d, e) <- t (d, e) / 2^30 mod l, d and e in (-2l, l) before and after:
// md, me start at u, q (d < 0) plus v, r (e < 0) and take the correction
// that clears the low 30 bits of t (d, e) + l (md, me)
__device__ __forceinline__ void update_de_30(s30& d, s30& e,
                                             const s30_trans& t) {
  const s30 l = s30_l();
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((kFlLInv30 * (uint32_t)cd + (uint32_t)md) & kM30);
  me -= (int32_t)((kFlLInv30 * (uint32_t)ce + (uint32_t)me) & kM30);
  cd += (int64_t)l.v[0] * md;
  ce += (int64_t)l.v[0] * me;
  cd >>= 30;                                 // the low 30 bits are 0
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] +
          (int64_t)l.v[i] * md;
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] +
          (int64_t)l.v[i] * me;
    d.v[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact (the low 30 bits are 0 by the divsteps)
__device__ __forceinline__ void update_fg_30(s30& f, s30& g,
                                             const s30_trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & kM30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & kM30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// x^-1 mod l (0 for 0), canonical; x < l.  eta starts at -1 (delta = 1).
__device__ __forceinline__ fl8 fl8_inv(const fl8& x) {
  s30 d = {{0, 0, 0, 0, 0, 0, 0, 0, 0}}, e = {{1, 0, 0, 0, 0, 0, 0, 0, 0}};
  s30 f = s30_l(), g = s30_from_fl8(x);
  int eta = -1;
  for (;;) {
    s30_trans t;
    eta = divsteps_30(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
    int32_t any = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) any |= g.v[i];
    if (!any) break;
  }
  if (f.v[8] < 0) s30_neg(d);                // f = -1: x^-1 = -d
  while (d.v[8] < 0) s30_add_l(d, 1);        // d in (-2l, 2l) -> [0, 2l)
  s30 r = d;
  s30_add_l(r, -1);
  const bool below = r.v[8] < 0;              // d < l: d, else d - l
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] = below ? d.v[i] : r.v[i];
  return s30_to_fl8(r);
}

// 1/x in Montgomery form: x_m = x 2^256 (mod l) -> x^-1 2^256.  fl8_inv
// gives x_m^-1 = x^-1 2^-256, and one product by 2^768 (mod l) / 2^256
// lifts it by 2^512.
__device__ __forceinline__ fl8 fl8_inv_mont(const fl8& x_m) {
  return fl8_mont_mul(fl8_inv(x_m), fl8_r3());
}

// Montgomery (R8) form -> ops/fl.py's Montgomery row (R = 2^260): x * 2^260
// mod l as 10 canonical limbs of 26 bits, int64 (the value is < l < 2^253)
__device__ __forceinline__ void fl8_to_fl_row(const fl8& x_m,
                                              int64_t* __restrict__ row) {
  const fl8 v = fl8_mont_mul(x_m, fl8_r260());
#pragma unroll
  for (int j = 0; j < 10; j++) {
    const int bit = 26 * j, w = bit >> 5, s = bit & 31;
    uint64_t word = v.w[w];
    if (w + 1 < 8) word |= (uint64_t)v.w[w + 1] << 32;
    row[j] = (int64_t)((word >> s) & ((1u << 26) - 1));
  }
}

}  // namespace bpg
