"""Byte <-> scalar conversions, semantics of reference src/conversions.rs.

Noteworthy behavior preserved exactly:
  * `be_to_scalars` reverses the *entire* byte string then chunks into
    32-byte little-endian limbs, so the limb order is the reverse of the
    big-endian block order (pinned by conversions.rs:140-150 tests).
  * Scalars are loaded with from_bits (raw, bit 255 masked, unreduced).
"""

from ..core.scalar import Scalar


def zero_pad(b: bytes, n: int) -> bytes:
    return b + b"\x00" * n


def remove_zero_padding(b: bytes) -> bytes:
    i = len(b)
    while i > 0 and b[i - 1] == 0:
        i -= 1
    return b[:i]


def le_to_scalars(b: bytes):
    if len(b) % 32 != 0:
        b = zero_pad(b, 32 - (len(b) % 32))
    return [Scalar.from_bits(b[i:i + 32]) for i in range(0, len(b), 32)]


def be_to_scalars(b: bytes):
    return le_to_scalars(bytes(reversed(b)))


def le_to_scalar(b: bytes) -> Scalar:
    assert len(b) <= 32, "the given vector is longer than 32 bytes"
    if len(b) % 32 != 0:
        b = zero_pad(b, 32 - (len(b) % 32))
    return Scalar.from_bits(b[:32])


def be_to_scalar(b: bytes) -> Scalar:
    return le_to_scalar(bytes(reversed(b)))


def scalar_to_be(s: Scalar) -> bytes:
    return bytes(reversed(s.as_bytes()))


def pkcs7_pad(b: bytes, block_size: int) -> bytes:
    """pkcs7 crate v1.0 semantics: pad to a multiple of block_size."""
    k = block_size - (len(b) % block_size)
    return b + bytes([k]) * k
