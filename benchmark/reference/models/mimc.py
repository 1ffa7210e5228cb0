"""Native (outside-the-circuit) MiMCHash-256b.

Semantics of reference src/mimc_hash/mimc.rs: sponge with rate 256 /
capacity 513, 486 rounds of state = (state + k + c_i)^3 over F_l, zero keys,
PKCS#7 byte padding of the last 32-byte block.  Bit-exact vectors pinned in
tests/test_mimc.py (mimc.rs:105-143).

Host arithmetic only (a few hundred bigint muls a block).
"""

from ..core.scalar import L, Scalar
from ..utils.conversions import (be_to_scalars, le_to_scalar,
                                 remove_zero_padding, pkcs7_pad)
from .mimc_constants import ROUND_CONSTANTS

NUM_ROUNDS = 486
BLOCK_SIZE = 32


def mimc_encryption(p: int, k: int, constants=ROUND_CONSTANTS) -> int:
    state = p % L
    k = k % L
    for c in constants:
        tmp = (state + k + c) % L
        state = tmp * tmp % L * tmp % L
    return (state + k) % L


def mimc_sponge(preimage_ints) -> int:
    state = 0
    for block in preimage_ints:
        state = (state + block) % L
        state = mimc_encryption(state, 0)
    return state


def pad_preimage(preimage_scalars):
    """mimc.rs pad(): PKCS#7 on the stripped LE bytes of the last block."""
    scalars = list(preimage_scalars)
    last = scalars[-1]
    last_le = remove_zero_padding(last.as_bytes())
    if len(last_le) < BLOCK_SIZE:
        padded = le_to_scalar(pkcs7_pad(last_le, BLOCK_SIZE))
        scalars.pop()
    else:
        padded = le_to_scalar(bytes([32]) * 32)
    scalars.append(padded)
    return scalars


def mimc_hash(preimage: bytes) -> Scalar:
    scalars = be_to_scalars(preimage)
    scalars = pad_preimage(scalars)
    return Scalar(mimc_sponge([s.v for s in scalars]))
