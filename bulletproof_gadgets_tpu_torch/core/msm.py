"""Multiscalar multiplication dispatch.

The MSM is THE hot path of the whole framework (SURVEY.md §3.1: the prover's
A_I/A_O/S commitments, every IPA round's L/R, and the verifier's single
mega-MSM).  The host implementation here is a plain Pippenger used as a
correctness oracle and for tiny inputs; the device backend
(ops/engine.register) installs itself via `set_backend` and
`set_table_factory` and takes over all sizes above its threshold.
"""

from .ristretto import RistrettoPoint
from .scalar import L

_backend = None
_BACKEND_MIN_SIZE = 64
_table_factory = None


def set_backend(backend, min_size: int = 64) -> None:
    """backend: callable(scalars: list[int], points: list[RistrettoPoint])
    -> RistrettoPoint"""
    global _backend, _BACKEND_MIN_SIZE
    _backend = backend
    _BACKEND_MIN_SIZE = min_size


def set_table_factory(factory) -> None:
    """factory(G, H, B, B_blinding) -> a table over the fixed points
    [G | H | B | B_blinding]: with `supports_digits` (ops/msm_serial
    GeneratorTable) it takes device digits (`msm_digits`); else it has
    msm_many(vectors: list[list[int]]) -> list[RistrettoPoint]."""
    global _table_factory
    _table_factory = factory


_table_min_size = None


def set_table_min_size(n) -> None:
    """Override the size threshold for device generator TABLES only (the
    A_I/A_O/S, IPA L/R and verifier mega-MSM path), leaving the generic
    msm() threshold alone.  Used by the multichip dryrun to route a tiny
    parity circuit through the sharded device pipeline without also sending
    every 2-point Pedersen commitment to the device.  None = follow the
    backend threshold."""
    global _table_min_size
    _table_min_size = n


class _HostTable:
    """Correctness-oracle table: plain per-vector host Pippenger."""

    def __init__(self, G, H, B, B_blinding):
        self.points = list(G) + list(H) + [B, B_blinding]
        self.N = len(G)
        self.m = len(self.points)

    def msm_many(self, vectors):
        return [msm_host([k % L for k in v], self.points) for v in vectors]


def generator_table(G, H, B, B_blinding):
    """Prover MSM table over [G | H | B | B_blinding] (device-resident when
    the device engine is registered and the size clears its threshold)."""
    min_size = (_table_min_size if _table_min_size is not None
                else _BACKEND_MIN_SIZE)
    if _table_factory is not None and (2 * len(G) + 2) >= min_size:
        return _table_factory(G, H, B, B_blinding)
    return _HostTable(G, H, B, B_blinding)


def msm(scalars, points) -> RistrettoPoint:
    """sum_i scalars[i] * points[i].

    scalars: iterable of core.scalar.Scalar (or raw ints)
    """
    ks = [s if isinstance(s, int) else s.v for s in scalars]
    points = list(points)
    assert len(ks) == len(points), (len(ks), len(points))
    if _backend is not None and len(ks) >= _BACKEND_MIN_SIZE:
        return _backend(ks, points)
    return msm_host(ks, points)


def msm_host(ks, points) -> RistrettoPoint:
    n = len(ks)
    if n == 0:
        return RistrettoPoint.identity()
    ks = [k % L for k in ks]
    # window size heuristic
    if n < 4:
        acc = RistrettoPoint.identity()
        for k, p in zip(ks, points):
            acc = acc + p.scalar_mul(k)
        return acc
    c = max(4, min(16, n.bit_length() - 2))
    windows = (253 + c - 1) // c
    acc = RistrettoPoint.identity()
    for w in range(windows - 1, -1, -1):
        if w != windows - 1:
            for _ in range(c):
                acc = acc.double()
        buckets = [None] * ((1 << c) - 1)
        shift = w * c
        mask = (1 << c) - 1
        for k, p in zip(ks, points):
            digit = (k >> shift) & mask
            if digit:
                b = buckets[digit - 1]
                buckets[digit - 1] = p if b is None else b + p
        # running-sum bucket aggregation
        running = RistrettoPoint.identity()
        window_sum = RistrettoPoint.identity()
        for b in reversed(buckets):
            if b is not None:
                running = running + b
            window_sum = window_sum + running
        acc = acc + window_sum
    return acc
