"""The transcript kernel's device code (csrc/transcript.cu's
transcript_round_one on csrc/keccak.cuh and csrc/field_l.cuh) built with
the host's C++ compiler and held against the host Merlin transcript
(utils/merlin) and Python ints, on the CPU.

That code is plain C++ apart from its CUDA qualifiers, which the harness
defines away, so the same STROBE byte machine, Keccak-f[1600], F_l
reduction and divsteps inversion that the card runs are checked here byte
for byte and limb for limb: states, positions, the ops/fl Montgomery rows
of the challenge and its inverse, and the inversion alone against
Python's pow.  The kernel launch itself (and the card) is
tests/test_torch_kernels.py's and chip_smoke.py's.  Skips where no g++ is
installed.
"""
import shutil
import subprocess

import numpy as np
import pytest

from bulletproof_gadgets_tpu_torch import native
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import fl
from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript

HARNESS = r"""
#define __device__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <string>
#include "transcript.cu"

static void read_hex(uint8_t* out, int n) {
  std::string s;
  std::cin >> s;
  for (int i = 0; i < n; i++)
    out[i] = (uint8_t)std::strtol(s.substr(2 * i, 2).c_str(), nullptr, 16);
}

static void print_fl8(const bpg::fl8& x) {
  for (int j = 7; j >= 0; j--) std::printf("%08x", x.w[j]);
  std::printf("\n");
}

int main() {
  int n;
  std::cin >> n;
  for (int t = 0; t < n; t++) {
    std::string mode;
    std::cin >> mode;
    bpg::RoundWork w;
    uint8_t ch[64];
    int32_t meta[3];
    int64_t u[20];
    if (mode == "inv") {                  // 32 bytes little-endian, < l
      uint8_t x[32];
      read_hex(x, 32);
      bpg::fl8 v;
      std::memcpy(v.w, x, 32);
      print_fl8(bpg::fl8_inv(v));
      continue;
    }
    if (mode == "round") {
      uint8_t st[200], enc[64];
      read_hex(st, 200);
      std::cin >> meta[0] >> meta[1] >> meta[2];
      read_hex(enc, 64);
      std::memcpy(w.lanes, st, 200);
      std::memcpy(w.op[1] + bpg::kOpHead + 2, enc, 32);
      std::memcpy(w.op[3] + bpg::kOpHead + 2, enc + 32, 32);
      bpg::transcript_round_one(w, meta, u);
      std::memcpy(st, w.lanes, 200);
      for (int i = 0; i < 200; i++) std::printf("%02x", st[i]);
      std::printf(" %d %d %d", meta[0], meta[1], meta[2]);
    } else {
      read_hex(ch, 64);
      bpg::challenge_rows_one(ch, u);
    }
    for (int i = 0; i < 20; i++) std::printf(" %lld", (long long)u[i]);
    std::printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", native.CSRC, "-o",
                    str(d / "harness"), str(d / "harness.cpp")], check=True,
                   capture_output=True)
    return str(d / "harness")


def _run(harness, lines):
    out = subprocess.run([harness], input=f"{len(lines)}\n" + "\n".join(
        lines) + "\n", capture_output=True, text=True, check=True).stdout
    return [line.split() for line in out.strip().splitlines()]


def _rows(ch: bytes):
    u = int.from_bytes(ch, "little") % L
    return fl.to_limbs([u * fl.R % L, pow(u, L - 2, L) * fl.R % L]
                       ).reshape(-1).tolist()


def test_transcript_round_one_matches_host_merlin(harness):
    """Eight transcripts whose prior message lengths put their STROBE
    positions all over the 166-byte rate, three chained rounds of seeded
    L/R encodings each: the device code's state, positions and rows equal
    the host loop's."""
    rng = np.random.default_rng(166)
    ts = []
    for n in (0, 10, 60, 100, 120, 140, 150, 160):
        t = Transcript(b"csrc-host")
        t.append_message(b"V", rng.bytes(n))
        ts.append(t)
    for _ in range(3):
        encs = [rng.bytes(64) for _ in ts]
        got = _run(harness, [
            f"round {bytes(t.strobe.state).hex()} {t.strobe.pos} "
            f"{t.strobe.pos_begin} {t.strobe.cur_flags} {e.hex()}"
            for t, e in zip(ts, encs)])
        for t, e, g in zip(ts, encs, got):
            t.append_message(b"L", e[:32])
            t.append_message(b"R", e[32:])
            ch = t.challenge_bytes(b"u", 64)
            assert g[0] == bytes(t.strobe.state).hex()
            assert [int(v) for v in g[1:4]] == [
                t.strobe.pos, t.strobe.pos_begin, t.strobe.cur_flags]
            assert [int(v) for v in g[4:]] == _rows(ch)


def test_challenge_chain_matches_python_ints(harness):
    """The F_l part on chosen challenge bytes (0, 1, values around l,
    2^252 and 2^256, near 2^512, and 64 seeded strings): Montgomery rows of
    the value mod l and of its inverse (divsteps, then one product back to
    Montgomery form), canonical limbs, against pow(u, l - 2, l)."""
    vals = [0, 1, L - 1, L, L + 1, 1 << 252, (1 << 256) - 1, 1 << 256,
            L << 256, (1 << 512) - 1, (1 << 512) - L]
    rng = np.random.default_rng(512)
    chs = [v.to_bytes(64, "little") for v in vals] + [
        rng.bytes(64) for _ in range(64)]
    got = _run(harness, [f"chal {c.hex()}" for c in chs])
    for c, g in zip(chs, got):
        assert [int(v) for v in g] == _rows(c)


def _inversion_inputs(kind):
    r = np.random.default_rng(253)
    if kind == "edges":                  # 0 -> 0, as x^(l-2) gives
        return [0, 1, 2, 3, L - 1, L - 2, (L - 1) // 2, 1 << 252,
                (1 << 252) - 1, ((1 << 256) - 1) % L, (1 << 255) % L] + [
                    1 << k for k in (29, 30, 31, 32, 60, 62, 64, 240, 241)]
    if kind == "short":                  # few bits: long runs of zeros
        return [int.from_bytes(r.bytes(32), "little") >> int(r.integers(
            3, 250)) for _ in range(200)]
    return [int.from_bytes(r.bytes(32), "little") % L for _ in range(2000)]


@pytest.mark.parametrize("kind", ["edges", "short", "seeded"])
def test_inversion_matches_python_ints(harness, kind):
    """fl8_inv, the divsteps inversion alone (values < l, as the kernel
    feeds it), against pow(x, l - 2, l): edge values, values of a few bits
    and 2,000 seeded values."""
    xs = _inversion_inputs(kind)
    got = _run(harness, [f"inv {x.to_bytes(32, 'little').hex()}"
                         for x in xs])
    for x, g in zip(xs, got):
        assert int(g[0], 16) == pow(x, L - 2, L), x
