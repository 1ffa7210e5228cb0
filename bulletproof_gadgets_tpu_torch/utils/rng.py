"""Blinding randomness.

The reference draws OS randomness for every Pedersen blinding
(reference src/gadget.rs:32, src/commitments.rs:28,40 and inside
`prover.prove`).  Blindings never need to match any other implementation —
only to be uniform — so we use a seedable ChaCha-free stdlib source:
`secrets` by default, or a deterministic stream when BPG_TPU_SEED is set
(determinism tests / reproducible proofs).

The ranks of a mesh (parallel/mesh.activate) run one host program, so
they must draw the same blindings: there the unseeded stream is SHAKE256
keyed by a secret that one rank drew and all of them hold (`share_key`).
"""
import hashlib
import os
import secrets

from ..core.scalar import L, Scalar

_seed = os.environ.get("BPG_TPU_SEED")
_counter = 0
_key = None             # the secret a mesh's ranks share (share_key)
_key_counter = 0        # its own count: no draw of its stream repeats


def set_seed(seed):
    """Set (or clear with None) the deterministic blinding seed."""
    global _seed, _counter
    _seed = None if seed is None else str(seed)
    _counter = 0


def share_key(key):
    """Draw unseeded blindings from SHAKE256 keyed by `key` (32 secret
    bytes that every rank of a mesh holds), or from `secrets` again (None).
    A seed set with set_seed comes first."""
    global _key, _key_counter
    _key = None if key is None else bytes(key)
    _key_counter = 0


def _next_keyed():
    """(key bytes, draw number) of the next draw from the seed's or the
    shared key's stream; None when draws are fresh."""
    global _counter, _key_counter
    if _seed is not None:
        _counter += 1
        return _seed.encode(), _counter
    if _key is not None:
        _key_counter += 1
        return _key, _key_counter
    return None


def random_scalar() -> Scalar:
    keyed = _next_keyed()
    if keyed is None:
        return Scalar(secrets.randbits(512) % L)
    stream = hashlib.shake_256(
        b"bpg-tpu-blinding" + keyed[0] + keyed[1].to_bytes(8, "little")
    ).digest(64)
    return Scalar(int.from_bytes(stream, "little") % L)


def random_scalars(count: int) -> list:
    """count uniform scalars with ONE entropy draw (seeded: one SHAKE256
    squeeze; unseeded: one secrets.token_bytes) instead of a per-scalar
    hash — the s_L/s_R blinding vectors are 2n scalars per prove and the
    per-call path costs ~2 us each in pure Python."""
    if count <= 0:
        return []
    keyed = _next_keyed()
    if keyed is None:
        stream = secrets.token_bytes(64 * count)
    else:
        stream = hashlib.shake_256(
            b"bpg-tpu-blinding-vec" + keyed[0]
            + keyed[1].to_bytes(8, "little")).digest(64 * count)
    return [Scalar(int.from_bytes(stream[64 * i:64 * i + 64], "little") % L)
            for i in range(count)]
