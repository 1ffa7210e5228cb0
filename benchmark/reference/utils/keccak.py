"""Keccak-f[1600] permutation (host side).

The Merlin transcript (Fiat-Shamir) used by the Bulletproofs protocol is built
on STROBE-128, which is built on Keccak-f[1600].  The transcript is a tiny,
latency-bound, strictly-sequential byte machine, so it lives on the host; the
TPU owns the bulk field/group math instead.

Behavioral reference: merlin 2.0.1 (STROBE) as consumed by the reference crate
(src/prove.rs:45, Cargo.toml:11).  Correctness of this
permutation is pinned by tests/test_keccak.py, which rebuilds SHA3-256 /
SHAKE256 on top of it and checks against hashlib.
"""

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] for the rho step (x = column, y = row).
_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(value: int, shift: int) -> int:
    if shift == 0:
        return value
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def keccak_f1600(lanes):
    """One Keccak-f[1600] permutation over 25 64-bit lanes.

    `lanes` is a list of 25 ints, indexed lane[x + 5*y]; mutated in place and
    returned.
    """
    a = lanes
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            for y in range(0, 25, 5):
                a[x + y] ^= dx
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROT[x][y])
        # chi
        for y in range(0, 25, 5):
            t = b[y:y + 5]
            for x in range(5):
                a[x + y] = t[x] ^ ((~t[(x + 1) % 5]) & t[(x + 2) % 5] & _MASK)
        # iota
        a[0] ^= rc
    return a


def f1600_bytes(state: bytearray) -> None:
    """Apply Keccak-f[1600] to a 200-byte state (little-endian lanes), in place."""
    lanes = [int.from_bytes(state[8 * i:8 * i + 8], "little") for i in range(25)]
    keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i:8 * i + 8] = lane.to_bytes(8, "little")
