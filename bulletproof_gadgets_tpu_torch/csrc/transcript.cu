// One round of the inner-product argument's Fiat-Shamir step on the card,
// for a group of B transcripts: for each, Merlin's append_message(b"L",
// L), append_message(b"R", R) and challenge_bytes(b"u", 64) on its STROBE
// state (keccak.cuh), then the challenge u = the 64 bytes mod l and its
// inverse (field_l.cuh), written as ops/fl.py Montgomery rows for the next
// fold.  It replaces the JAX package's jnp round step under jit
// (bulletproof_gadgets_tpu/ops/ipa_fused.py:122 _round_fs, on
// ops/strobe_device.py and ops/keccak_device.py), which has no Pallas
// kernel; plain version: ops/strobe_device.transcript_round_plain, which
// computes the same bytes and canonical rows by other steps (a batched
// duplex, u^(l-2) by 4-bit windows).
//
// Bound on the H100: latency.  A round has one to five transcripts, one
// thread (and block) each, and each is one dependent chain: ~91 bytes
// absorbed and 64 squeezed, one or two Keccak-f[1600], and the challenge's
// inversion.  The
// design keeps that chain short and out of local memory (0 bytes of stack):
//   * the inversion is Bernstein-Yang's divsteps in batches of 30
//     (field_l.cuh fl8_inv, variable time: u is public), 32 x 32 -> 64
//     products of limbs by small matrices, where x^(l-2) took a chain of
//     298 Montgomery products; one product brings it back to Montgomery
//     form, and 4 more reduce the 64 bytes and write the rows;
//   * the duplex runs on the block's work area in shared memory (byte
//     positions are run-time values), each Keccak-f[1600] on the 25 lanes
//     in registers, and the round's six STROBE operations through one loop
//     with one permutation site;
// all in one launch per round, next to the data: the encodings come from
// ristretto_compress on the card, and u, u^-1 stay there for the fold, so
// the argument reads nothing back until its end.
#include <stdint.h>

#include "field_l.cuh"
#include "keccak.cuh"

namespace bpg {

// One transcript's round work area (8-byte aligned; the block's shared
// memory in the kernel): the STROBE state, the round's six operations'
// bytes, each behind its 2-byte head (op k's head at kOpHead, its bytes from
// kOpHead + 2: k = 0, 2, 4 the frames' meta-AD of L, R and u, k = 1, 3 the
// messages L and R, k = 5 the challenge's head alone), and the challenge.
constexpr int kOpHead = 6;
struct RoundWork {
  uint64_t lanes[25];
  uint8_t op[6][40];
  uint8_t ch[64];
};

// The challenge's F_l part: 64 bytes -> u (20 int64: the ops/fl
// Montgomery rows of u = the bytes mod l and of u^-1)
__device__ __forceinline__ void challenge_rows_one(
    const uint8_t* __restrict__ ch, int64_t* __restrict__ u) {
  const fl8 u_m = fl8_from_wide_mont(ch);
  fl8_to_fl_row(u_m, u);
  fl8_to_fl_row(fl8_inv_mont(u_m), u + 10);
}

// One transcript's round on w (its state, and L | R at op[1], op[3] from
// kOpHead + 2) and meta (pos, pos_begin, cur_flags; updated) -> the new
// state in w, the challenge bytes in w.ch and u.  Plain C++ apart from the
// qualifiers, so a host compiler builds it too
// (tests/test_torch_csrc_host.py).
__device__ __forceinline__ void transcript_round_one(
    RoundWork& w, int32_t* __restrict__ meta, int64_t* __restrict__ u) {
  const uint8_t labels[3] = {'L', 'R', 'u'};
#pragma unroll
  for (int k = 0; k < 3; k++) {                // frame: label, 4-byte length
    uint8_t* m = w.op[2 * k] + kOpHead + 2;
    m[0] = labels[k];
    m[1] = k == 2 ? 64 : 32;
    m[2] = m[3] = m[4] = 0;
  }
  Strobe s = {reinterpret_cast<uint8_t*>(w.lanes), meta[0], meta[1],
              meta[2]};
#pragma unroll 1
  for (int k = 0; k < 6; k++) {
    const int flags = k == 5 ? kFlagI | kFlagA | kFlagC
                             : (k & 1) ? kFlagA : kFlagM | kFlagA;
    const int n = k == 5 ? 0 : (k & 1) ? 32 : 5;
    uint8_t* op = w.op[k] + kOpHead;
    s.begin_op(flags, op);
    s.absorb(op, 2 + n, k == 5);
  }
  s.squeeze(w.ch, 64);
  meta[0] = s.pos;
  meta[1] = s.pos_begin;
  meta[2] = s.cur_flags;
  challenge_rows_one(w.ch, u);
}

}  // namespace bpg

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void copy64(uint64_t* __restrict__ dst,
                                       const uint64_t* __restrict__ src,
                                       int n) {
#pragma unroll
  for (int i = 0; i < n; i++) dst[i] = src[i];
}

// block b, one thread: transcript b of state [B, 200], meta [B, 3], enc
// [B, 2, 32], chal [B, 64] (or null; then only the F_l part, on chal's
// bytes) -> state_out, meta_out, u [B, 2, 10]; the byte tensors 8-byte
// aligned (the wrappers check).  A block per transcript: its values then
// depend on blockIdx alone (the byte machine's positions are warp-uniform)
// and transcripts whose inversions take other paths do not share a warp;
// it ran faster than 32 transcripts a block at B = 1 and 8 (PERF.md §6).
__global__ void __launch_bounds__(1)
transcript_round_kernel(const uint8_t* __restrict__ state,
                        const int32_t* __restrict__ meta,
                        const uint8_t* __restrict__ enc,
                        const uint8_t* __restrict__ chal,
                        uint8_t* __restrict__ state_out,
                        int32_t* __restrict__ meta_out,
                        int64_t* __restrict__ u) {
  __shared__ bpg::RoundWork w;
  const int b = blockIdx.x;
  if (chal) {
    copy64(reinterpret_cast<uint64_t*>(w.ch),
           reinterpret_cast<const uint64_t*>(chal + 64 * b), 8);
    bpg::challenge_rows_one(w.ch, u + 20 * b);
    return;
  }
  copy64(w.lanes, reinterpret_cast<const uint64_t*>(state + 200 * b), 25);
  for (int h = 0; h < 2; h++)
    copy64(reinterpret_cast<uint64_t*>(w.op[1 + 2 * h] + bpg::kOpHead + 2),
           reinterpret_cast<const uint64_t*>(enc + 64 * b + 32 * h), 4);
  int32_t m[3] = {meta[3 * b], meta[3 * b + 1], meta[3 * b + 2]};
  bpg::transcript_round_one(w, m, u + 20 * b);
  copy64(reinterpret_cast<uint64_t*>(state_out + 200 * b), w.lanes, 25);
#pragma unroll
  for (int i = 0; i < 3; i++) meta_out[3 * b + i] = m[i];
}

// Latency probes (chip_smoke.py's latency bounds), one thread each: n
// dependent fl8_mont_mul (x squared n times), n dependent inversions
// fl8_inv_mont (of x + 1, of that + 1, ...: each input a new value, as the
// inversion's time depends on it) and n Keccak-f[1600] of 25 lanes in
// shared memory, as the transcript kernel runs them.  Their data are read
// at offsets of threadIdx.x: on values it proves warp-uniform the compiler
// would run a chain on the uniform datapath (UIMAD), whose latency is not
// the vector IMADs'.
__global__ void fl8_mul_chain_kernel(const uint32_t* __restrict__ x, int n,
                                     uint32_t* __restrict__ out) {
  bpg::fl8 v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = x[8 * threadIdx.x + j];
  for (int i = 0; i < n; i++) v = bpg::fl8_mont_mul(v, v);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * threadIdx.x + j] = v.w[j];
}

__global__ void fl8_inv_chain_kernel(const uint32_t* __restrict__ x, int n,
                                     uint32_t* __restrict__ out) {
  bpg::fl8 v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.w[j] = x[8 * threadIdx.x + j];
  const bpg::fl8 one = bpg::fl8_one_mont();
  for (int i = 0; i < n; i++) v = bpg::fl8_inv_mont(bpg::fl8_add(v, one));
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * threadIdx.x + j] = v.w[j];
}

__global__ void f1600_chain_kernel(const uint64_t* __restrict__ x, int n,
                                   uint64_t* __restrict__ out) {
  __shared__ uint64_t lanes[25];
  copy64(lanes, x + 25 * threadIdx.x, 25);
  for (int i = 0; i < n; i++) bpg::keccak_f1600(lanes);
  copy64(out + 25 * threadIdx.x, lanes, 25);
}

}  // namespace

extern "C" {

int bpg_transcript_round(const void* state, const void* meta, const void* enc,
                         const void* chal, int B, void* state_out,
                         void* meta_out, void* u, void* stream) {
  transcript_round_kernel<<<B, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const int32_t*)meta, (const uint8_t*)enc,
      (const uint8_t*)chal, (uint8_t*)state_out, (int32_t*)meta_out,
      (int64_t*)u);
  return (int)cudaGetLastError();
}

int bpg_fl8_mul_chain(const void* x, int n, void* out, void* stream) {
  fl8_mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_fl8_inv_chain(const void* x, int n, void* out, void* stream) {
  fl8_inv_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

int bpg_f1600_chain(const void* x, int n, void* out, void* stream) {
  f1600_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, n, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // __CUDACC__
