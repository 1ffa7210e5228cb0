"""Keccak-f[1600] on torch tensors: the port of the JAX package's
ops/keccak_device.py, the permutation of the device transcript.

This is the plain version of the permutation inside the transcript kernel
(csrc/keccak.cuh, launched per IPA round by ops/strobe_device.
transcript_round): a batch of B states, each 25 64-bit lanes carried as two
int64 [B, 25] tensors of 32-bit halves (lo, hi), so that every shift stays
inside int64 (torch has no uint64 shifts).  Rotations and the lane
permutation are static; one permutation is 24 rounds of ~50 tensor ops.

Host oracle: utils/keccak.py (pinned to hashlib's SHA-3 by the JAX
package's tests/test_keccak.py); tests/test_torch_device_transcript.py
holds this module against it and against the JAX package's f1600.
"""
import functools

import torch

from ..utils.keccak import _ROT, _ROUND_CONSTANTS

M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _tables(device):
    """Per output lane j = x + 5y of rho+pi: its source lane and rotation;
    chi's two partner lanes; the round constants' halves."""
    src, rot = [0] * 25, [0] * 25
    for x in range(5):
        for y in range(5):
            j = y + 5 * ((2 * x + 3 * y) % 5)
            src[j], rot[j] = x + 5 * y, _ROT[x][y]
    chi1 = [(j % 5 + 1) % 5 + 5 * (j // 5) for j in range(25)]
    chi2 = [(j % 5 + 2) % 5 + 5 * (j // 5) for j in range(25)]

    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)
    rot_t = t(rot)
    return (t(src), rot_t >= 32, rot_t % 32, t(chi1), t(chi2),
            t([rc & M32 for rc in _ROUND_CONSTANTS]),
            t([rc >> 32 for rc in _ROUND_CONSTANTS]))


def _rotl(lo, hi, swap, s):
    """Rotate left by 32 * swap + s (0 <= s < 32, per lane or scalar): the
    halves swap, then each takes its top bits from the other (for s = 0 the
    other's contribution, a 32-bit value shifted right by 32, is 0)."""
    x_lo, x_hi = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    return (((x_lo << s) | (x_hi >> (32 - s))) & M32,
            ((x_hi << s) | (x_lo >> (32 - s))) & M32)


def f1600(lo, hi):
    """One permutation of each of B states: lo, hi int64 [B, 25] (lane
    x + 5y, 32-bit halves, little-endian pairs) -> the permuted halves."""
    src, swap, s, chi1, chi2, rc_lo, rc_hi = _tables(lo.device)
    no = torch.zeros((), dtype=torch.bool, device=lo.device)
    for r in range(24):
        # theta: C[x] = xor of column x; D[x] = C[x-1] ^ rotl(C[x+1], 1)
        a_lo, a_hi = lo.view(-1, 5, 5), hi.view(-1, 5, 5)     # [B, y, x]
        c_lo = a_lo[:, 0] ^ a_lo[:, 1] ^ a_lo[:, 2] ^ a_lo[:, 3] ^ a_lo[:, 4]
        c_hi = a_hi[:, 0] ^ a_hi[:, 1] ^ a_hi[:, 2] ^ a_hi[:, 3] ^ a_hi[:, 4]
        r_lo, r_hi = _rotl(c_lo, c_hi, no, 1)
        d_lo = c_lo.roll(1, -1) ^ r_lo.roll(-1, -1)
        d_hi = c_hi.roll(1, -1) ^ r_hi.roll(-1, -1)
        lo = (a_lo ^ d_lo[:, None, :]).reshape(-1, 25)
        hi = (a_hi ^ d_hi[:, None, :]).reshape(-1, 25)
        # rho + pi, as a gather: output lane j is source lane src[j] rotated
        b_lo, b_hi = _rotl(lo[:, src], hi[:, src], swap, s)
        # chi
        lo = b_lo ^ (~b_lo[:, chi1] & b_lo[:, chi2])
        hi = b_hi ^ (~b_hi[:, chi1] & b_hi[:, chi2])
        # iota
        lo = torch.cat([lo[:, :1] ^ rc_lo[r], lo[:, 1:]], 1)
        hi = torch.cat([hi[:, :1] ^ rc_hi[r], hi[:, 1:]], 1)
    return lo, hi


def state_to_lanes(state):
    """uint8 [B, 200] -> (lo, hi) int64 [B, 25]."""
    b = state.to(torch.int64).view(-1, 25, 2, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return w[..., 0], w[..., 1]


def lanes_to_state(lo, hi):
    """(lo, hi) int64 [B, 25] -> uint8 [B, 200]."""
    w = torch.stack([lo, hi], -1)                       # [B, 25, 2]
    parts = torch.stack([(w >> (8 * q)) & 0xFF for q in range(4)], -1)
    return parts.reshape(-1, 200).to(torch.uint8)


def f1600_state(state):
    """uint8 [B, 200] states -> permuted, same layout."""
    return lanes_to_state(*f1600(*state_to_lanes(state)))
