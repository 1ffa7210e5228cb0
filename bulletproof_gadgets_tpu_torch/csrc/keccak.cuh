// Keccak-f[1600] and the STROBE-128 duplex of Merlin transcripts (merlin
// 2.0.1, as utils/merlin.py implements it on the host) for the transcript
// kernel (transcript.cu).  One thread runs one transcript.
//
// No local memory: the 200-byte state lives in a buffer the caller gives
// (shared memory in the kernel), which the byte machine addresses at its
// run-time positions; keccak_f1600 loads the 25 lanes into registers
// (static indices only), permutes them there with the round constants in
// __constant__ memory, and stores them back.  A round's STROBE operations
// run through one loop with one permutation site (transcript.cu), so the
// permutation's code is inlined once.
// Plain versions: ops/keccak_device.py (f1600 on lane halves) and
// ops/strobe_device.py (DeviceStrobe), which follow utils/merlin.py step
// for step.
#pragma once
#include <stdint.h>

namespace bpg {

__constant__ uint64_t kKeccakRc[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) {
  return s ? (x << s) | (x >> (64 - s)) : x;
}

// one permutation of 25 lanes, lane x + 5 y (utils/keccak.keccak_f1600),
// in place on a (8-byte aligned) buffer
__device__ __forceinline__ void keccak_f1600(uint64_t* __restrict__ a) {
  // rotation of lane x + 5 y (utils/keccak._ROT[x][y])
  const int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; i++) s[i] = a[i];
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++)
      c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) s[x + y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; x++)
#pragma unroll
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y],
                                                  rot[x + 5 * y]);
#pragma unroll
    for (int y = 0; y < 25; y += 5)
#pragma unroll
      for (int x = 0; x < 5; x++)
        s[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
    s[0] ^= kKeccakRc[r];
  }
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = s[i];
}

constexpr int kStrobeR = 166;
enum { kFlagI = 1, kFlagA = 2, kFlagC = 4, kFlagM = 16, kFlagK = 32 };

// STROBE-128's duplex over a 200-byte state (the lanes little-endian) at
// st, its positions in registers
struct Strobe {
  uint8_t* st;
  int pos, pos_begin, cur_flags;

  __device__ __forceinline__ void run_f() {
    st[pos] ^= (uint8_t)pos_begin;
    st[pos + 1] ^= 0x04;
    st[kStrobeR + 1] ^= 0x80;
    keccak_f1600(reinterpret_cast<uint64_t*>(st));
    pos = 0;
    pos_begin = 0;
  }
  // a new operation's head: Merlin never continues one with other flags.
  // The 2 head bytes are [pos_begin, flags]; the caller absorbs them.
  __device__ __forceinline__ void begin_op(int flags, uint8_t* head) {
    head[0] = (uint8_t)pos_begin;
    head[1] = (uint8_t)flags;
    pos_begin = pos + 1;
    cur_flags = flags;
  }
  // absorb n bytes, then (force) the permutation if the operation needs
  // the state fresh (C or K flag) and pos is not 0: begin_op's
  // "if (flags & (C | K)) && pos != 0: run_f".  The permutation's one
  // call site serves both the rate and the forced one.
  __device__ __forceinline__ void absorb(const uint8_t* data, int n,
                                         bool force) {
    for (;;) {
      const int m = n < kStrobeR - pos ? n : kStrobeR - pos;
      for (int i = 0; i < m; i++) st[pos + i] ^= data[i];
      pos += m;
      data += m;
      n -= m;
      if (pos == kStrobeR || (n == 0 && force && pos != 0)) run_f();
      if (n == 0) break;
    }
  }
  // n bytes out, each state byte then zeroed (STROBE's PRF).  Merlin's
  // challenge starts at pos 0 (its C flag forces the permutation), so n
  // <= kStrobeR - pos holds and the squeeze never reaches the rate.
  __device__ __forceinline__ void squeeze(uint8_t* out, int n) {
    for (int i = 0; i < n; i++) {
      out[i] = st[pos + i];
      st[pos + i] = 0;
    }
    pos += n;
  }
};

}  // namespace bpg
