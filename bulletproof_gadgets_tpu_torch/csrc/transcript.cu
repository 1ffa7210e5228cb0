// One round of the inner-product argument's Fiat-Shamir step on the card,
// for a group of B transcripts: for each, Merlin's append_message(b"L",
// L), append_message(b"R", R) and challenge_bytes(b"u", 64) on its STROBE
// state (keccak.cuh), then the challenge u = the 64 bytes mod l and its
// inverse (field_l.cuh), written as ops/fl.py Montgomery rows for the next
// fold.  It replaces the JAX package's jnp round step under jit
// (bulletproof_gadgets_tpu/ops/ipa_fused.py:122 _round_fs, on
// ops/strobe_device.py and ops/keccak_device.py), which has no Pallas
// kernel; plain version: ops/strobe_device.transcript_round_plain.
//
// Bound on the H100: latency.  One thread per transcript runs a serial byte
// machine (~155 bytes through the duplex and one or two f1600 of 24 rounds)
// and then the challenge's inversion, 252 squarings and 46 products in F_l;
// a round has one to five transcripts.  The design keeps all of it in one
// launch per round, next to the data: the encodings come from
// ristretto_compress on the card, and u, u^-1 stay there for the fold, so
// the argument reads nothing back until its end.
#include <stdint.h>

#include "field_l.cuh"
#include "keccak.cuh"

namespace bpg {

// One transcript's round: state 200 bytes, meta (pos, pos_begin,
// cur_flags), enc L | R (64 bytes) -> state_out, meta_out and u (20
// int64: the ops/fl Montgomery rows of u and u^-1).  With chal non-null
// the STROBE part is skipped and the challenge is chal's 64 bytes (a check
// of the F_l part on chosen bytes); state_out and meta_out are then not
// written.  Plain C++ apart from the qualifiers, so a host compiler builds
// it too (tests/test_torch_csrc_host.py).
__device__ __forceinline__ void transcript_round_one(
    const uint8_t* __restrict__ state, const int32_t* __restrict__ meta,
    const uint8_t* __restrict__ enc, const uint8_t* __restrict__ chal,
    uint8_t* __restrict__ state_out, int32_t* __restrict__ meta_out,
    int64_t* __restrict__ u) {
  uint8_t ch[64];
  if (chal) {
    for (int i = 0; i < 64; i++) ch[i] = chal[i];
  } else {
    Strobe s;
    for (int i = 0; i < 25; i++) {
      uint64_t v = 0;
      for (int q = 0; q < 8; q++) v |= (uint64_t)state[8 * i + q] << (8 * q);
      s.lanes[i] = v;
    }
    s.pos = meta[0];
    s.pos_begin = meta[1];
    s.cur_flags = meta[2];
    s.append_message('L', enc, 32);
    s.append_message('R', enc + 32, 32);
    s.challenge_bytes('u', ch, 64);
    for (int i = 0; i < 200; i++) state_out[i] = s.get(i);
    meta_out[0] = s.pos;
    meta_out[1] = s.pos_begin;
    meta_out[2] = s.cur_flags;
  }
  const fl8 u_m = fl8_from_wide_mont(ch);
  fl8_to_fl_row(u_m, u);
  fl8_to_fl_row(fl8_inv_mont(u_m), u + 10);
}

}  // namespace bpg

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kTranscriptThreads = 32;

// thread b: transcript b of state [B, 200], meta [B, 3], enc [B, 2, 32],
// chal [B, 64] (or null) -> state_out, meta_out, u [B, 2, 10]
__global__ void __launch_bounds__(kTranscriptThreads)
transcript_round_kernel(const uint8_t* __restrict__ state,
                        const int32_t* __restrict__ meta,
                        const uint8_t* __restrict__ enc,
                        const uint8_t* __restrict__ chal, int B,
                        uint8_t* __restrict__ state_out,
                        int32_t* __restrict__ meta_out,
                        int64_t* __restrict__ u) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (chal)
    bpg::transcript_round_one(nullptr, nullptr, nullptr, chal + 64 * b,
                              nullptr, nullptr, u + 20 * b);
  else
    bpg::transcript_round_one(state + 200 * b, meta + 3 * b, enc + 64 * b,
                              nullptr, state_out + 200 * b,
                              meta_out + 3 * b, u + 20 * b);
}

// Latency probe (chip_smoke.py's latency bound): one thread squares x (< l)
// n times in a dependent chain of fl8_mont_mul, the product the
// challenge's inversion is made of
__global__ void fl8_sqr_chain_kernel(const uint32_t* __restrict__ x, int n,
                                     uint32_t* __restrict__ out) {
  bpg::fl8 v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = x[j];
  for (int i = 0; i < n; i++) v = bpg::fl8_mont_mul(v, v);
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = v.w[j];
}

}  // namespace

extern "C" {

int bpg_transcript_round(const void* state, const void* meta, const void* enc,
                         const void* chal, int B, void* state_out,
                         void* meta_out, void* u, void* stream) {
  transcript_round_kernel<<<(B + kTranscriptThreads - 1) / kTranscriptThreads,
                            kTranscriptThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const int32_t*)meta, (const uint8_t*)enc,
      (const uint8_t*)chal, B, (uint8_t*)state_out, (int32_t*)meta_out,
      (int64_t*)u);
  return (int)cudaGetLastError();
}

int bpg_fl8_sqr_chain(const void* x, int n, void* out, void* stream) {
  fl8_sqr_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // __CUDACC__
