"""Blinding randomness.

The reference draws OS randomness for every Pedersen blinding
(reference src/gadget.rs:32, src/commitments.rs:28,40 and inside
`prover.prove`).  Blindings never need to match any other implementation —
only to be uniform — so we use a seedable ChaCha-free stdlib source:
`secrets` by default, or a deterministic stream when BPG_TPU_SEED is set
(determinism tests / reproducible proofs).
"""
import hashlib
import os
import secrets

from ..core.scalar import L, Scalar

_seed = os.environ.get("BPG_TPU_SEED")
_counter = 0


def set_seed(seed):
    """Set (or clear with None) the deterministic blinding seed."""
    global _seed, _counter
    _seed = None if seed is None else str(seed)
    _counter = 0


def random_scalar() -> Scalar:
    global _counter
    if _seed is None:
        return Scalar(secrets.randbits(512) % L)
    _counter += 1
    stream = hashlib.shake_256(
        b"bpg-tpu-blinding" + _seed.encode() + _counter.to_bytes(8, "little")
    ).digest(64)
    return Scalar(int.from_bytes(stream, "little") % L)


def random_scalars(count: int) -> list:
    """count uniform scalars with ONE entropy draw (seeded: one SHAKE256
    squeeze; unseeded: one secrets.token_bytes) instead of a per-scalar
    hash — the s_L/s_R blinding vectors are 2n scalars per prove and the
    per-call path costs ~2 us each in pure Python."""
    global _counter
    if count <= 0:
        return []
    if _seed is None:
        stream = secrets.token_bytes(64 * count)
    else:
        _counter += 1
        stream = hashlib.shake_256(
            b"bpg-tpu-blinding-vec" + _seed.encode()
            + _counter.to_bytes(8, "little")).digest(64 * count)
    return [Scalar(int.from_bytes(stream[64 * i:64 * i + 64], "little") % L)
            for i in range(count)]
