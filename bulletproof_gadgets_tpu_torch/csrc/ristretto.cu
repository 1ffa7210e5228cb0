// Ristretto255 compression of MSM results on the card: [4, 10, k] extended
// points (any carried limbs, as K5 and K7 write them) -> [k, 32] RFC 9496
// encodings, one thread per point, on field32.cuh's radix-2^32 core.  It
// replaces the JAX package's jnp compression under jit
// (bulletproof_gadgets_tpu/ops/ristretto_device.py:173 compress_cols), which
// has no Pallas kernel; plain version: ops/ristretto_device.compress_cols,
// the same formulas and exponent chain on the 10-limb plain field ops, so
// the encodings are equal byte for byte.
//
// Bound on the H100: latency.  A point is one dependent chain of 278 field
// operations, 255 of them squarings: the inverse square root's z^(2^252 -
// 3) (251 squarings, 11 products; no shorter chain exists for it) and ~25
// around it; the IPA compresses 2 points a round (the commitments 3), so
// the card runs one warp.  The design shortens each link: the squarings
// use fe8_sqr (36 word products where fe8_mul forms 64), the chain is
// inlined with no call frame (0 bytes of stack), and the inverse square
// root is RFC 9496's SQRT_RATIO_M1 at u = 1, which drops the three
// products by u.  Bytes out, so the transcript kernel reads them where
// they are.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "field32.cuh"

using namespace bpg;

namespace {

constexpr int kCompressThreads = 32;

__device__ __forceinline__ fe8 fe8_sqrt_m1() {  // sqrt(-1), even root
  fe8 r = {{0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u, 0x3dfbd7a7u,
            0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u}};
  return r;
}

__device__ __forceinline__ fe8 fe8_invsqrt_a_minus_d() {  // 1/sqrt(-1 - d)
  fe8 r = {{0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u, 0xfe01d840u,
            0x16c27b91u, 0xcfaffca2u, 0x786c8905u}};
  return r;
}

__device__ __forceinline__ bool fe8_eq(const fe8& a, const fe8& b) {
  const fe8 x = fe8_canonical(a), y = fe8_canonical(b);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 8; i++) eq &= x.w[i] == y.w[i];
  return eq;
}

__device__ __forceinline__ bool fe8_is_negative(const fe8& a) {
  return fe8_canonical(a).w[0] & 1;
}

__device__ __forceinline__ fe8 fe8_neg(const fe8& a) {
  return fe8_sub(fe8_small(0), a);
}

__device__ __forceinline__ fe8 fe8_select(bool c, const fe8& a,
                                          const fe8& b) {
  fe8 r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// |a|: the canonical value of a or of -a, whichever is even
__device__ __forceinline__ fe8 fe8_abs(const fe8& a) {
  const fe8 c = fe8_canonical(a);
  return (c.w[0] & 1) ? fe8_canonical(fe8_neg(c)) : c;
}

// x^(2^n), n dependent squarings (a loop: the chain's code stays small)
__device__ __forceinline__ fe8 fe8_sqn(fe8 x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) x = fe8_sqr(x);
  return x;
}

// z^((p-5)/8) = z^(2^252 - 3): the curve25519 chain to z^(2^250 - 1), two
// squarings and one product (251 squarings, 11 products)
__device__ __forceinline__ fe8 fe8_pow_p58(const fe8& z) {
  const fe8 z2 = fe8_sqr(z);
  const fe8 z9 = fe8_mul(fe8_sqn(z2, 2), z);
  const fe8 z11 = fe8_mul(z9, z2);
  const fe8 z_5_0 = fe8_mul(fe8_sqr(z11), z9);
  const fe8 z_10_0 = fe8_mul(fe8_sqn(z_5_0, 5), z_5_0);
  const fe8 z_20_0 = fe8_mul(fe8_sqn(z_10_0, 10), z_10_0);
  const fe8 z_40_0 = fe8_mul(fe8_sqn(z_20_0, 20), z_20_0);
  const fe8 z_50_0 = fe8_mul(fe8_sqn(z_40_0, 10), z_10_0);
  const fe8 z_100_0 = fe8_mul(fe8_sqn(z_50_0, 50), z_50_0);
  const fe8 z_200_0 = fe8_mul(fe8_sqn(z_100_0, 100), z_100_0);
  const fe8 z_250_0 = fe8_mul(fe8_sqn(z_200_0, 50), z_50_0);
  return fe8_mul(fe8_sqn(z_250_0, 2), z);
}

// RFC 9496 SQRT_RATIO_M1(1, v): the non-negative sqrt(1/v) (or
// sqrt(i/v)); core/ristretto.sqrt_ratio_m1's steps at u = 1
__device__ __forceinline__ fe8 fe8_invsqrt(const fe8& v) {
  const fe8 v3 = fe8_mul(fe8_sqr(v), v);
  const fe8 v7 = fe8_mul(fe8_sqr(v3), v);
  fe8 r = fe8_mul(v3, fe8_pow_p58(v7));
  const fe8 check = fe8_mul(v, fe8_sqr(r));
  const fe8 neg_sqrt_m1 = fe8_neg(fe8_sqrt_m1());
  const bool flip = fe8_eq(check, fe8_neg(fe8_small(1))) ||
                    fe8_eq(check, neg_sqrt_m1);
  r = fe8_select(flip, fe8_mul(r, fe8_sqrt_m1()), r);
  return fe8_abs(r);
}

// RFC 9496 ENCODE of one extended point (core/ristretto.compress's steps)
__device__ __forceinline__ fe8 ristretto_encode(const ge8& p) {
  const fe8 u1 = fe8_mul(fe8_add(p.Z, p.Y), fe8_sub(p.Z, p.Y));
  const fe8 u2 = fe8_mul(p.X, p.Y);
  const fe8 is = fe8_invsqrt(fe8_mul(u1, fe8_sqr(u2)));
  const fe8 den1 = fe8_mul(is, u1);
  const fe8 den2 = fe8_mul(is, u2);
  const fe8 z_inv = fe8_mul(fe8_mul(den1, den2), p.T);
  const fe8 ix = fe8_mul(p.X, fe8_sqrt_m1());
  const fe8 iy = fe8_mul(p.Y, fe8_sqrt_m1());
  const fe8 ench = fe8_mul(den1, fe8_invsqrt_a_minus_d());
  const bool rotate = fe8_is_negative(fe8_mul(p.T, z_inv));
  const fe8 x = fe8_select(rotate, iy, p.X);
  fe8 y = fe8_select(rotate, ix, p.Y);
  const fe8 den_inv = fe8_select(rotate, ench, den2);
  y = fe8_select(fe8_is_negative(fe8_mul(x, z_inv)), fe8_neg(y), y);
  return fe8_abs(fe8_mul(den_inv, fe8_sub(p.Z, y)));
}

// thread j: point j of pts [4, 10, k] -> out[j * 32 .. j * 32 + 31]
__global__ void __launch_bounds__(kCompressThreads)
ristretto_compress_kernel(const int32_t* __restrict__ pts, int k,
                          uint8_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const fe8 s = ristretto_encode(ge8_from_carried(ge_load(pts, k, j)));
#pragma unroll
  for (int i = 0; i < 32; i++)
    out[32 * j + i] = (uint8_t)(s.w[i / 4] >> (8 * (i % 4)));
}

// Latency probes (chip_smoke.py's latency bound): one thread squares x n
// times in a dependent chain of fe8_mul(v, v) or of fe8_sqr, the two
// operations the compression's chain is made of.  x is read at
// 8 * threadIdx.x, as the kernel reads per-thread points: on values the
// compiler proves warp-uniform the chain would run on the uniform datapath
// (UIMAD), which the kernel's chain does not use.
template <bool kSqr>
__global__ void fe8_chain_kernel(const uint32_t* __restrict__ x, int n,
                                 uint32_t* __restrict__ out) {
  fe8 v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = x[8 * threadIdx.x + j];
  for (int i = 0; i < n; i++) v = kSqr ? fe8_sqr(v) : fe8_mul(v, v);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * threadIdx.x + j] = v.w[j];
}

}  // namespace

extern "C" {

int bpg_ristretto_compress(const void* pts, int k, void* out, void* stream) {
  ristretto_compress_kernel<<<(k + kCompressThreads - 1) / kCompressThreads,
                              kCompressThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pts, k, (uint8_t*)out);
  return (int)cudaGetLastError();
}

int bpg_fe8_mul_chain(const void* x, int n, void* out, void* stream) {
  fe8_chain_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_fe8_sqr_chain(const void* x, int n, void* out, void* stream) {
  fe8_chain_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
