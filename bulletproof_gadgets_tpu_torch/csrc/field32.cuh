// F_p (p = 2^255 - 19) in radix 2^32 with PTX carry chains: the field core
// of the bucket accumulation (K1, K2, K8-K10 in msm_kernels.cu), of the
// chunk combine (K7) and of the compression (ristretto.cu).  K3-K6 keep
// field.cuh's 10-limb core.
//
// fe8: 8 x 32-bit words, little-endian, any value < 2^256 standing for its
// residue mod p (lazy: 2^256 = 2 * 2^255 = 38 mod p, so a word carried out
// of the top wraps to 38).  Kernels convert canonical 10-limb operands in
// (fe8_from_limbs) and write canonical limbs out (fe8_to_canonical_limbs),
// so their outputs are the unique limbs in [0, 2^w) of each coordinate.
//
// fe8_mul: the 8 x 8 schoolbook product as rows of mad.lo.cc / madc.hi.cc
// (one multiply-add each for the low and the high half of a 32 x 32
// product, the carry inside the instruction), then the fold of the high 256
// bits x 38.  That is 64 word products and 16 for the fold, against the
// 10-limb core's 100 int64 products and its 12-step rounding carry: 127
// SASS instructions against fe_mul's 221 (scripts/sass_counts.py).  Each
// carry chain sits in one asm statement: the compiler keeps no carry flag
// between statements.  fe8_sqr: a square on the same pairs from 36 word
// products (the 28 cross products once, doubled by funnel shifts, and the
// 8 squares) and the same fold.
// tests/test_torch_bounds.py models every instruction below on Python ints
// and checks that no step needs more than its 32-bit word and the carry
// flag, and that every result is < 2^256 and right mod p.
#pragma once
#include <stdint.h>

#include "field.cuh"

namespace bpg {

struct fe8 {
  uint32_t w[8];
};

struct ge8 {  // extended coordinates, as ge
  fe8 X, Y, Z, T;
};

__device__ __forceinline__ fe8 fe8_small(uint32_t v) {
  fe8 r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = 0;
  r.w[0] = v;
  return r;
}

// a + b: the sum's carry out of 2^256 adds 38; that addition's own carry
// (only when the sum wrapped to < 38 + 38) adds 38 to word 0 alone, which
// cannot carry: after a wrap, word 0 is < 76 and every other word 0.
__device__ __forceinline__ fe8 fe8_add(const fe8& a, const fe8& b) {
  fe8 r;
  asm("{\n\t.reg .u32 c;\n\t"
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.cc.u32 %7, %15, %23;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mul.lo.u32 c, c, 38;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.u32 %0, c, 38, %0;\n\t}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]),
        "=&r"(r.w[4]), "=&r"(r.w[5]), "=&r"(r.w[6]), "=&r"(r.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  return r;
}

// a - b: a borrow out of 2^256 subtracts 38, at most twice; the second
// time (the first wrap left < 38) it touches word 0 alone, which is then
// >= 2^32 - 38 and cannot borrow.
__device__ __forceinline__ fe8 fe8_sub(const fe8& a, const fe8& b) {
  fe8 r;
  asm("{\n\t.reg .u32 c;\n\t"
      "sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.cc.u32 %7, %15, %23;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "and.b32 c, c, 38;\n\t"
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "and.b32 c, c, 38;\n\t"
      "sub.u32 %0, %0, c;\n\t}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]),
        "=&r"(r.w[4]), "=&r"(r.w[5]), "=&r"(r.w[6]), "=&r"(r.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  return r;
}

// One carry chain of the product: acc[0..7] += x0 b, x1 b, x2 b, x3 b as
// 64-bit values at words 0, 2, 4, 6 (mad.lo.cc / madc.hi.cc of one 32 x 32
// product on a word pair, which the H100 runs as one 64-bit multiply-add
// with carry, IMAD.WIDE.U32.X), then the carry out of word 7:
//   kCarryAdd: acc[8] += carry;  kCarrySet: acc[8] = carry (acc[8] may be
//   one of the x, read before);  kCarryNone: none (the caller proves that
//   word 7 cannot carry out).
enum { kCarryAdd, kCarrySet, kCarryNone };

template <int kMode>
__device__ __forceinline__ void fe8_chain(uint32_t* acc, uint32_t x0,
                                          uint32_t x1, uint32_t x2,
                                          uint32_t x3, uint32_t b) {
#define BPG_CHAIN_BODY                         \
  "mad.lo.cc.u32 %0, %9, %13, %0;\n\t"         \
  "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"        \
  "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"       \
  "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"       \
  "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"       \
  "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"       \
  "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
#define BPG_CHAIN_ARGS                                                   \
  "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]), \
      "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
  if (kMode == kCarryAdd) {
    asm(BPG_CHAIN_BODY "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
                       "addc.u32 %8, %8, 0;"
        : BPG_CHAIN_ARGS, "+r"(acc[8])
        : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(b));
  } else if (kMode == kCarrySet) {
    asm(BPG_CHAIN_BODY "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
                       "addc.u32 %8, 0, 0;"
        : BPG_CHAIN_ARGS, "=r"(acc[8])
        : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(b));
  } else {
    uint32_t unused = 0;  // keeps the body's operand numbers
    asm(BPG_CHAIN_BODY "madc.hi.u32 %7, %12, %13, %7;"
        : BPG_CHAIN_ARGS, "+r"(unused)
        : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(b));
  }
#undef BPG_CHAIN_BODY
#undef BPG_CHAIN_ARGS
}

// Step 2 and 3 of the product (and of the square): E, O with E + O =
// the 512-bit value (O[0] = 0) -> the value mod p as 8 words < 2^256, by
// low + 38 high on E's and O's own pairs.  O[8] is overwritten.
__device__ __forceinline__ fe8 fe8_fold(uint32_t* E, uint32_t* O) {
  fe8_chain<kCarrySet>(E, E[8], E[10], E[12], E[14], 38);
  fe8_chain<kCarryAdd>(E, O[8], O[10], O[12], O[14], 38);
  const uint32_t e9 = E[9], e11 = E[11], e13 = E[13], e15 = E[15];
  const uint32_t o9 = O[9], o11 = O[11], o13 = O[13], o15 = O[15];
  O[8] = 0;
  fe8_chain<kCarryNone>(O + 1, e9, e11, e13, e15, 38);
  fe8_chain<kCarryNone>(O + 1, o9, o11, o13, o15, 38);
  fe8 r;
  asm("{\n\t.reg .u32 c;\n\t"
      "add.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.cc.u32 %7, %15, %23;\n\t"
      "addc.u32 c, %16, %24;\n\t"
      "mul.lo.u32 c, c, 38;\n\t"
      "add.cc.u32 %0, %8, c;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.u32 %0, c, 38, %0;\n\t}"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]),
        "=&r"(r.w[4]), "=&r"(r.w[5]), "=&r"(r.w[6]), "=&r"(r.w[7])
      : "r"(E[0]), "r"(E[1]), "r"(E[2]), "r"(E[3]), "r"(E[4]), "r"(E[5]),
        "r"(E[6]), "r"(E[7]), "r"(E[8]), "r"(O[1]), "r"(O[2]), "r"(O[3]),
        "r"(O[4]), "r"(O[5]), "r"(O[6]), "r"(O[7]), "r"(O[8]));
  return r;
}

// a * b mod p, any a, b < 2^256, result < 2^256.  A 32 x 32 product lands
// as a word pair at word i + j (a's word j, b's word i); the products with
// i + j even accumulate in E, on the pairs (0, 1), (2, 3), ..., those with
// i + j odd in O, on the pairs (1, 2), (3, 4), ...: so each accumulator
// keeps one pairing throughout, and no word moves between register pairs.
//   1. row 0 (b's word 0): the eight products, no addend and no carry;
//      row i = 1..7: one chain into E (a's words of i's parity, from word
//      i rounded up to even) and one into O (the other four, from i rounded
//      up to odd), each with its carry word; E's last (words 8..15) has
//      none, as E <= a * b < 2^512.  E + O = a * b (words 0..15);
//   2. the fold low + 38 high, 2^256 = 38 mod p, on the same pairs:
//      38 x E's and O's even high words (8, 10, 12, 14) into E's words
//      0..7 with carry words into E[8]; 38 x the odd ones (9, ..., 15)
//      into O's words 1..8, which cannot carry out of word 8 (O's part
//      is < 77 * 2^256);
//   3. r = E + O (words 0..8) = E_lo + O_lo + 38 (E_hi + O_hi), where
//      E_hi + O_hi <= the product's high half < 2^256, so r < 40 * 2^256
//      and its word 8 is <= 39; r0..r7 += 38 r8 (<= 1,482), and the carry
//      word of that, if any, adds 38 to word 0 alone, which cannot carry:
//      a carry here means the sum wrapped to < 1,482, so word 0 is < 1,482
//      + 38 and the others 0.  Nothing is left over; the result < 2^256.
__device__ __forceinline__ fe8 fe8_mul(const fe8& a, const fe8& b) {
  const uint32_t* x = a.w;
  uint32_t E[16], O[16];
#pragma unroll
  for (int k = 0; k < 16; k++) E[k] = O[k] = 0;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    E[j] = x[j] * b.w[0];
    E[j + 1] = __umulhi(x[j], b.w[0]);
    O[j + 1] = x[j + 1] * b.w[0];
    O[j + 2] = __umulhi(x[j + 1], b.w[0]);
  }
#pragma unroll
  for (int i = 1; i < 8; i++) {
    const int o = i & 1;               // a's words j = o, o+2, .. go to E
    if (i < 7)
      fe8_chain<kCarryAdd>(E + i + o, x[o], x[o + 2], x[o + 4], x[o + 6],
                           b.w[i]);
    else
      fe8_chain<kCarryNone>(E + i + o, x[o], x[o + 2], x[o + 4], x[o + 6],
                            b.w[i]);
    fe8_chain<kCarryAdd>(O + i + 1 - o, x[1 - o], x[3 - o], x[5 - o],
                         x[7 - o], b.w[i]);
  }
  return fe8_fold(E, O);
}

// acc[0 .. 2n-1] += x[j] * b as word pairs at 2j (j < n = 3, 2, 1), then
// the carry out into acc[2n]: fe8_chain's kCarryAdd for the shorter rows
// of the square
__device__ __forceinline__ void fe8_chain3(uint32_t* acc, uint32_t x0,
                                           uint32_t x1, uint32_t x2,
                                           uint32_t b) {
  asm("mad.lo.cc.u32 %0, %7, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
      "addc.u32 %6, %6, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6])
      : "r"(x0), "r"(x1), "r"(x2), "r"(b));
}

__device__ __forceinline__ void fe8_chain2(uint32_t* acc, uint32_t x0,
                                           uint32_t x1, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
      "addc.u32 %4, %4, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
      : "r"(x0), "r"(x1), "r"(b));
}

__device__ __forceinline__ void fe8_chain1(uint32_t* acc, uint32_t x0,
                                           uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2])
      : "r"(x0), "r"(b));
}

// a^2 mod p, any a < 2^256, result < 2^256: 36 word products (the 28
// cross products a_i a_j, i < j, once, and the 8 squares) where fe8_mul
// forms 64, on fe8_mul's pairing (a_i a_j lands at word i + j: E for i + j
// even, O for odd) and with its fold:
//   1. the cross products, row i = a_i (a_{i+1} .. a_7): row 0 with no
//      addend and no carry, rows 1..6 one chain of 1-3 products into E and
//      one into O, each with its carry word, which no earlier chain has
//      reached beyond a carry of 1 (so the carry add cannot wrap);
//      E + O = C = the sum of a_i a_j 2^(32 (i + j)), i < j, < 2^511;
//   2. E, O <- 2 E, 2 O by funnel shifts (each < 2^511, so no bit is
//      lost; O[0] stays 0), then E += the squares a_i^2 on its pairs
//      (2i, 2i + 1), one chain with no carry out: 2 C + the squares = a^2
//      < 2^512;
//   3. fe8_fold, as fe8_mul: E + O = a^2, so its bounds hold as they are.
__device__ __forceinline__ fe8 fe8_sqr(const fe8& a) {
  const uint32_t* x = a.w;
  uint32_t E[16], O[16];
#pragma unroll
  for (int k = 0; k < 16; k++) E[k] = O[k] = 0;
#pragma unroll
  for (int j = 1; j < 8; j++) {                 // row 0
    uint32_t* acc = (j & 1) ? O : E;
    acc[j] = x[0] * x[j];
    acc[j + 1] = __umulhi(x[0], x[j]);
  }
  fe8_chain3(O + 3, x[2], x[4], x[6], x[1]);    // words 3, 5, 7; carry 9
  fe8_chain3(E + 4, x[3], x[5], x[7], x[1]);    // 4, 6, 8; 10
  fe8_chain3(O + 5, x[3], x[5], x[7], x[2]);    // 5, 7, 9; 11
  fe8_chain2(E + 6, x[4], x[6], x[2]);          // 6, 8; 10
  fe8_chain2(O + 7, x[4], x[6], x[3]);          // 7, 9; 11
  fe8_chain2(E + 8, x[5], x[7], x[3]);          // 8, 10; 12
  fe8_chain2(O + 9, x[5], x[7], x[4]);          // 9, 11; 13
  fe8_chain1(E + 10, x[6], x[4]);               // 10; 12
  fe8_chain1(O + 11, x[6], x[5]);               // 11; 13
  fe8_chain1(E + 12, x[7], x[5]);               // 12; 14
  fe8_chain1(O + 13, x[7], x[6]);               // 13; 15
#pragma unroll
  for (int k = 15; k > 0; k--) {
    E[k] = __funnelshift_l(E[k - 1], E[k], 1);
    O[k] = __funnelshift_l(O[k - 1], O[k], 1);
  }
  E[0] <<= 1;
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]),
        "+r"(E[5]), "+r"(E[6]), "+r"(E[7]), "+r"(E[8]), "+r"(E[9]),
        "+r"(E[10]), "+r"(E[11]), "+r"(E[12]), "+r"(E[13]), "+r"(E[14]),
        "+r"(E[15])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]));
  return fe8_fold(E, O);
}

// canonical 26/25-bit limbs (field.cuh's layout, each in [0, 2^w)) -> the
// same value in words, by shifts: limb i sits at bit S_i = 0, 26, 51, 77,
// 102, 128, 153, 179, 204, 230
__device__ __forceinline__ fe8 fe8_from_limbs(const fe& a) {
  const uint32_t* l = reinterpret_cast<const uint32_t*>(a.v);
  fe8 r;
  r.w[0] = l[0] | (l[1] << 26);
  r.w[1] = (l[1] >> 6) | (l[2] << 19);
  r.w[2] = (l[2] >> 13) | (l[3] << 13);
  r.w[3] = (l[3] >> 19) | (l[4] << 6);
  r.w[4] = l[5] | (l[6] << 25);
  r.w[5] = (l[6] >> 7) | (l[7] << 19);
  r.w[6] = (l[7] >> 13) | (l[8] << 12);
  r.w[7] = (l[8] >> 20) | (l[9] << 6);
  return r;
}

// a - p if that does not borrow, else a
__device__ __forceinline__ fe8 fe8_sub_p_if_ge(const fe8& a) {
  fe8 d;
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, 0xffffffed;\n\t"
      "subc.cc.u32 %1, %10, 0xffffffff;\n\t"
      "subc.cc.u32 %2, %11, 0xffffffff;\n\t"
      "subc.cc.u32 %3, %12, 0xffffffff;\n\t"
      "subc.cc.u32 %4, %13, 0xffffffff;\n\t"
      "subc.cc.u32 %5, %14, 0xffffffff;\n\t"
      "subc.cc.u32 %6, %15, 0xffffffff;\n\t"
      "subc.cc.u32 %7, %16, 0x7fffffff;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=&r"(d.w[0]), "=&r"(d.w[1]), "=&r"(d.w[2]), "=&r"(d.w[3]),
        "=&r"(d.w[4]), "=&r"(d.w[5]), "=&r"(d.w[6]), "=&r"(d.w[7]),
        "=r"(borrow)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]));
  fe8 r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = borrow ? a.w[i] : d.w[i];
  return r;
}

// the canonical value of a mod p: a < 2^256 < 3p, so two conditional
// subtractions of p leave it in [0, p)
__device__ __forceinline__ fe8 fe8_canonical(const fe8& a) {
  return fe8_sub_p_if_ge(fe8_sub_p_if_ge(a));
}

// the unique limbs in [0, 2^w) of a mod p: limb i is bits S_i .. S_i + w_i
// - 1 of fe8_canonical(a)
__device__ __forceinline__ fe fe8_to_canonical_limbs(const fe8& a) {
  const fe8 c = fe8_canonical(a);
  const uint32_t* w = c.w;
  constexpr uint32_t M26 = (1u << 26) - 1, M25 = (1u << 25) - 1;
  fe r;
  r.v[0] = (int32_t)(w[0] & M26);
  r.v[1] = (int32_t)(__funnelshift_r(w[0], w[1], 26) & M25);
  r.v[2] = (int32_t)(__funnelshift_r(w[1], w[2], 19) & M26);
  r.v[3] = (int32_t)(__funnelshift_r(w[2], w[3], 13) & M25);
  r.v[4] = (int32_t)((w[3] >> 6) & M26);
  r.v[5] = (int32_t)(w[4] & M25);
  r.v[6] = (int32_t)(__funnelshift_r(w[4], w[5], 25) & M26);
  r.v[7] = (int32_t)(__funnelshift_r(w[5], w[6], 19) & M25);
  r.v[8] = (int32_t)(__funnelshift_r(w[6], w[7], 12) & M26);
  r.v[9] = (int32_t)((w[7] >> 6) & M25);
  return r;
}

__device__ __forceinline__ ge8 ge8_from_limbs(const ge& p) {
  ge8 r;
  r.X = fe8_from_limbs(p.X);
  r.Y = fe8_from_limbs(p.Y);
  r.Z = fe8_from_limbs(p.Z);
  r.T = fe8_from_limbs(p.T);
  return r;
}

__device__ __forceinline__ ge ge8_to_canonical_limbs(const ge8& p) {
  ge r;
  r.X = fe8_to_canonical_limbs(p.X);
  r.Y = fe8_to_canonical_limbs(p.Y);
  r.Z = fe8_to_canonical_limbs(p.Z);
  r.T = fe8_to_canonical_limbs(p.T);
  return r;
}

__device__ __forceinline__ ge8 ge8_identity() {
  ge8 r;
  r.X = fe8_small(0);
  r.Y = fe8_small(1);
  r.Z = fe8_small(1);
  r.T = fe8_small(0);
  return r;
}

// a point of 10-limb carried coordinates (|limb| < 2^28 - 152, as every
// 10-limb kernel writes them) -> ge8, through field.cuh's fe_canonical
__device__ __forceinline__ ge8 ge8_from_carried(const ge& p) {
  ge8 r;
  r.X = fe8_from_limbs(fe_canonical(p.X));
  r.Y = fe8_from_limbs(fe_canonical(p.Y));
  r.Z = fe8_from_limbs(fe_canonical(p.Z));
  r.T = fe8_from_limbs(fe_canonical(p.T));
  return r;
}

// 2d mod p in words (field.cuh's fe_d2)
__device__ __forceinline__ fe8 fe8_d2() {
  fe8 r = {{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u,
            0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}};
  return r;
}

// unified addition: ge_add's formula (ops/curve.padd), 9 products
__device__ __forceinline__ ge8 ge8_add(const ge8& p, const ge8& q) {
  const fe8 a = fe8_mul(fe8_sub(p.Y, p.X), fe8_sub(q.Y, q.X));
  const fe8 b = fe8_mul(fe8_add(p.Y, p.X), fe8_add(q.Y, q.X));
  const fe8 c = fe8_mul(fe8_mul(p.T, q.T), fe8_d2());
  const fe8 zz = fe8_mul(p.Z, q.Z);
  const fe8 d = fe8_add(zz, zz);
  const fe8 e = fe8_sub(b, a), f = fe8_sub(d, c), g = fe8_add(d, c),
            h = fe8_add(b, a);
  ge8 r;
  r.X = fe8_mul(e, f);
  r.Y = fe8_mul(g, h);
  r.Z = fe8_mul(f, g);
  r.T = fe8_mul(e, h);
  return r;
}

// mixed addition of an affine operand with t2d = x*y*2d: ge_madd's formula
// (ops/curve.madd), 7 products
__device__ __forceinline__ ge8 ge8_madd(const ge8& p, const fe8& x2,
                                        const fe8& y2, const fe8& t2d) {
  const fe8 a = fe8_mul(fe8_sub(p.Y, p.X), fe8_sub(y2, x2));
  const fe8 b = fe8_mul(fe8_add(p.Y, p.X), fe8_add(y2, x2));
  const fe8 c = fe8_mul(p.T, t2d);
  const fe8 d = fe8_add(p.Z, p.Z);
  const fe8 e = fe8_sub(b, a), f = fe8_sub(d, c), g = fe8_add(d, c),
            h = fe8_add(b, a);
  ge8 r;
  r.X = fe8_mul(e, f);
  r.Y = fe8_mul(g, h);
  r.Z = fe8_mul(f, g);
  r.T = fe8_mul(e, h);
  return r;
}

}  // namespace bpg
