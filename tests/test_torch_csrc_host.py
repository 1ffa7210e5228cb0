"""The transcript kernel's device code (csrc/transcript.cu's
transcript_round_one on csrc/keccak.cuh and csrc/field_l.cuh) built with
the host's C++ compiler and held against the host Merlin transcript
(utils/merlin) and Python ints, on the CPU.

That code is plain C++ apart from its CUDA qualifiers, which the harness
defines away, so the same STROBE byte machine, Keccak-f[1600] and F_l
Montgomery chain that the card runs are checked here byte for byte and
limb for limb: states, positions, and the ops/fl Montgomery rows of the
challenge and its inverse.  The kernel launch itself (and the card) is
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
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#include <cstdio>
#include <cstdlib>
#include <iostream>
#include <string>
#include "transcript.cu"

static void read_hex(uint8_t* out, int n) {
  std::string s;
  std::cin >> s;
  for (int i = 0; i < n; i++)
    out[i] = (uint8_t)std::strtol(s.substr(2 * i, 2).c_str(), nullptr, 16);
}

int main() {
  int n;
  std::cin >> n;
  for (int t = 0; t < n; t++) {
    std::string mode;
    std::cin >> mode;
    uint8_t st[200], enc[64], ch[64], st_out[200];
    int32_t meta[3], meta_out[3] = {0, 0, 0};
    int64_t u[20];
    if (mode == "round") {
      read_hex(st, 200);
      std::cin >> meta[0] >> meta[1] >> meta[2];
      read_hex(enc, 64);
      bpg::transcript_round_one(st, meta, enc, nullptr, st_out, meta_out, u);
      for (int i = 0; i < 200; i++) std::printf("%02x", st_out[i]);
      std::printf(" %d %d %d", meta_out[0], meta_out[1], meta_out[2]);
    } else {
      read_hex(ch, 64);
      bpg::transcript_round_one(nullptr, nullptr, nullptr, ch, nullptr,
                                nullptr, u);
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
    """The F_l part on chosen challenge bytes (0, 1, values around l and
    2^256, near 2^512, and 20 seeded strings): Montgomery rows of the value
    mod l and of its inverse, canonical limbs."""
    vals = [0, 1, L - 1, L, L + 1, (1 << 256) - 1, 1 << 256, L << 256,
            (1 << 512) - 1, (1 << 512) - L]
    rng = np.random.default_rng(512)
    chs = [v.to_bytes(64, "little") for v in vals] + [
        rng.bytes(64) for _ in range(20)]
    got = _run(harness, [f"chal {c.hex()}" for c in chs])
    for c, g in zip(chs, got):
        assert [int(v) for v in g] == _rows(c)
