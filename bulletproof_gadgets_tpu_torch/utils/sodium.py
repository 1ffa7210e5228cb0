"""External Ristretto255 oracle via libsodium (ctypes).

libsodium >= 1.0.18 ships an independent, widely-deployed Ristretto255
implementation (crypto_core_ristretto255_* / crypto_scalarmult_ristretto255).
It is interoperable with curve25519-dalek by construction (both implement
the ristretto255 group of RFC 9496), so it serves as the *external*
cross-validation oracle for:

  * point encode/decode (compressed 32-byte wire format — the `.coms`
    file contract, reference src/lalrpop/assignment_parser.rs:137-138)
  * the group law (add) and scalar multiplication
  * the Elligator2 map from 64 uniform bytes
    (dalek RistrettoPoint::from_uniform_bytes == sodium from_hash), which is
    the core of the BulletproofGens chain derivation
    (invoked by the reference at reference src/prove.rs:78)
  * the scalar field mod l (add/mul/invert/reduce)

All functions below raise if libsodium is unavailable; tests gate on
`available()`.
"""
import ctypes
import ctypes.util

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libsodium.so.23", "libsodium.so", "sodium",
                 ctypes.util.find_library("sodium")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            lib.sodium_init()
            lib.crypto_core_ristretto255_add  # probe ristretto API
            _lib = lib
            return lib
        except (OSError, AttributeError):
            continue
    raise OSError("libsodium with ristretto255 support not found")


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _buf(n=32):
    return ctypes.create_string_buffer(n)


def is_valid_point(p: bytes) -> bool:
    return _load().crypto_core_ristretto255_is_valid_point(p) == 1


def add(p: bytes, q: bytes) -> bytes:
    out = _buf()
    rc = _load().crypto_core_ristretto255_add(out, p, q)
    if rc != 0:
        raise ValueError("invalid point")
    return out.raw


def sub(p: bytes, q: bytes) -> bytes:
    out = _buf()
    rc = _load().crypto_core_ristretto255_sub(out, p, q)
    if rc != 0:
        raise ValueError("invalid point")
    return out.raw


def from_hash(h64: bytes) -> bytes:
    assert len(h64) == 64
    out = _buf()
    _load().crypto_core_ristretto255_from_hash(out, h64)
    return out.raw


def scalarmult(n32: bytes, p: bytes) -> bytes:
    """n * P.  libsodium refuses a zero result (returns -1) — callers must
    avoid n == 0 mod l and identity results."""
    out = _buf()
    rc = _load().crypto_scalarmult_ristretto255(out, n32, p)
    if rc != 0:
        raise ValueError("scalarmult failed (zero scalar or identity result)")
    return out.raw


def scalarmult_base(n32: bytes) -> bytes:
    out = _buf()
    rc = _load().crypto_scalarmult_ristretto255_base(out, n32)
    if rc != 0:
        raise ValueError("zero scalar")
    return out.raw


def scalar_mul(a32: bytes, b32: bytes) -> bytes:
    out = _buf()
    _load().crypto_core_ristretto255_scalar_mul(out, a32, b32)
    return out.raw


def scalar_add(a32: bytes, b32: bytes) -> bytes:
    out = _buf()
    _load().crypto_core_ristretto255_scalar_add(out, a32, b32)
    return out.raw


def scalar_invert(a32: bytes) -> bytes:
    out = _buf()
    rc = _load().crypto_core_ristretto255_scalar_invert(out, a32)
    if rc != 0:
        raise ValueError("cannot invert zero")
    return out.raw


def scalar_reduce(a64: bytes) -> bytes:
    assert len(a64) == 64
    out = _buf()
    _load().crypto_core_ristretto255_scalar_reduce(out, a64)
    return out.raw
