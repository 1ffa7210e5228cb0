// Keccak-f[1600] and the STROBE-128 duplex of Merlin transcripts (merlin
// 2.0.1, as utils/merlin.py implements it on the host) for the transcript
// kernel (transcript.cu).  One thread runs one transcript: its 200-byte
// state in local memory, its byte positions in registers.
// Plain versions: ops/keccak_device.py (f1600 on lane halves) and
// ops/strobe_device.py (DeviceStrobe), which follow utils/merlin.py step
// for step.
#pragma once
#include <stdint.h>

namespace bpg {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int s) {
  return s ? (x << s) | (x >> (64 - s)) : x;
}

// one permutation of 25 lanes, lane x + 5 y (utils/keccak.keccak_f1600)
__device__ __noinline__ void keccak_f1600(uint64_t* a) {
  const uint64_t rc[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  // rotation of lane x + 5 y (utils/keccak._ROT[x][y])
  const int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                       25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; i++) s[i] = a[i];
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
    s[0] ^= rc[r];
  }
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = s[i];
}

constexpr int kStrobeR = 166;
enum { kFlagI = 1, kFlagA = 2, kFlagC = 4, kFlagM = 16, kFlagK = 32 };

// STROBE-128's duplex over a 200-byte state (the lanes little-endian)
struct Strobe {
  uint64_t lanes[25];
  int pos, pos_begin, cur_flags;

  __device__ __forceinline__ uint8_t get(int i) const {
    return (uint8_t)(lanes[i >> 3] >> (8 * (i & 7)));
  }
  __device__ __forceinline__ void put_xor(int i, uint8_t v) {
    lanes[i >> 3] ^= (uint64_t)v << (8 * (i & 7));
  }
  __device__ __forceinline__ void run_f() {
    put_xor(pos, (uint8_t)pos_begin);
    put_xor(pos + 1, 0x04);
    put_xor(kStrobeR + 1, 0x80);
    keccak_f1600(lanes);
    pos = 0;
    pos_begin = 0;
  }
  __device__ __forceinline__ void absorb(const uint8_t* data, int n) {
    for (int i = 0; i < n; i++) {
      put_xor(pos, data[i]);
      if (++pos == kStrobeR) run_f();
    }
  }
  __device__ __forceinline__ void squeeze(uint8_t* out, int n) {
    for (int i = 0; i < n; i++) {
      out[i] = get(pos);
      put_xor(pos, out[i]);                // state byte := 0
      if (++pos == kStrobeR) run_f();
    }
  }
  // a new operation (Merlin never continues one with other flags)
  __device__ __forceinline__ void begin_op(int flags) {
    const uint8_t head[2] = {(uint8_t)pos_begin, (uint8_t)flags};
    pos_begin = pos + 1;
    cur_flags = flags;
    absorb(head, 2);
    if ((flags & (kFlagC | kFlagK)) && pos != 0) run_f();
  }
  // Merlin's framing: meta-AD of the label and of the 4-byte length
  __device__ __forceinline__ void frame(uint8_t label, uint32_t len) {
    const uint8_t meta[5] = {label, (uint8_t)len, (uint8_t)(len >> 8),
                             (uint8_t)(len >> 16), (uint8_t)(len >> 24)};
    begin_op(kFlagM | kFlagA);
    absorb(meta, 5);                      // label, then the length (more)
  }
  __device__ __forceinline__ void append_message(uint8_t label,
                                                 const uint8_t* msg, int n) {
    frame(label, n);
    begin_op(kFlagA);
    absorb(msg, n);
  }
  __device__ __forceinline__ void challenge_bytes(uint8_t label,
                                                  uint8_t* out, int n) {
    frame(label, n);
    begin_op(kFlagI | kFlagA | kFlagC);
    squeeze(out, n);
  }
};

}  // namespace bpg
