// F_l (l = 2^252 + 27742317777372353535851937790883648493, the Ristretto255
// group order) for the transcript kernel (transcript.cu): Montgomery form
// over 8 x 32-bit words with R8 = 2^256, the IPA challenge's reduction and
// inversion, and the conversion to ops/fl.py's rows (10 limbs of 26 bits,
// Montgomery R = 2^260), which the device fold consumes.
//
// fl8_mont_mul is word-serial Montgomery multiplication (CIOS) with 64-bit
// intermediates: each a_j * b_i + t_j + carry < 2^64.  With a < l and
// b < 2^256 the result before its one conditional subtraction is
// < (l * 2^256 + 2^256 * l) / 2^256 = 2l < 2^254, so nine words suffice and
// the output is canonical (< l).  Every operand below is canonical or a
// 32-byte string (< 2^256) multiplied by a canonical constant.
// Plain version: ops/ristretto_device.py (challenge_limbs, to_mont_dev,
// inv_mont) on ops/fl.py, which compute the same canonical values.
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

// x^(l-2) = 1/x in Montgomery form, by 4-bit windows of l - 2 from the
// top (ops/ristretto_device.inv_mont, the JAX package's inv_mont): a table
// of x^0 .. x^15, then per window four squarings and, for a window that is
// not zero, one product (252 squarings and 14 + 32 products)
__device__ __noinline__ fl8 fl8_inv_mont(const fl8& x) {
  // l - 2's 64 windows below the top one (which is 1), high to low
  const uint8_t nib[63] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                           0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
                           4, 13, 14, 15, 9, 13, 14, 10, 2, 15, 7, 9, 12,
                           13, 6, 5, 8, 1, 2, 6, 3, 1, 10, 5, 12, 15, 5,
                           13, 3, 14, 11};
  fl8 tab[16];
  tab[0] = fl8_one_mont();
  tab[1] = x;
  for (int i = 2; i < 16; i++) tab[i] = fl8_mont_mul(tab[i - 1], x);
  fl8 acc = x;
  for (int i = 0; i < 63; i++) {
#pragma unroll
    for (int s = 0; s < 4; s++) acc = fl8_mont_mul(acc, acc);
    if (nib[i]) acc = fl8_mont_mul(acc, tab[nib[i]]);
  }
  return acc;
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
