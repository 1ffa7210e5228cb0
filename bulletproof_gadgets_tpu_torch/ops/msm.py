"""Signed digit recoding for the bucket MSM (ops/msm_serial).

Counterpart of `signed_digits` in the JAX package's ops/msm.py; the jnp
scan MSM around it there is not ported (the serial-bucket pipeline
replaced it).
"""
import numpy as np


def signed_digits(scalars, c: int) -> np.ndarray:
    """[n] ints (already reduced mod L) -> [n, windows] int32 signed digits,
    value = sum digits[i] * 2^(c*i).  c must be 8 or 16."""
    n = len(scalars)
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    if c == 8:
        digits = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32)
    elif c == 16:
        digits = np.frombuffer(raw, dtype="<u2").reshape(n, 16)
    else:
        raise ValueError("c must be 8 or 16")
    digits = digits.astype(np.int32)
    # signed recoding: digit >= 2^(c-1) -> digit - 2^c, carry into next
    half = 1 << (c - 1)
    carry = np.zeros(n, dtype=np.int32)
    for w in range(digits.shape[1]):
        d = digits[:, w] + carry
        carry = (d >= half).astype(np.int32)
        digits[:, w] = d - (carry << c)
    # scalars < L < 2^253, so the top window absorbs any carry
    assert not carry.any(), "scalar overflow in signed recoding"
    return digits
