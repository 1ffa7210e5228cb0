"""Pedersen and Bulletproof generators, matching dalek `bulletproofs` 2.x
generator derivation exactly (the reference constructs them at
reference src/prove.rs:46,78 and reference src/verify.rs:70).

Derivation rules (bulletproofs::generators):
  * PedersenGens::default(): B = Ristretto basepoint,
    B_blinding = RistrettoPoint::hash_from_bytes::<Sha3_512>(B.compress())
  * BulletproofGens: per party j, G chain label b"G" + u32le(j), H chain label
    b"H" + u32le(j); chain = SHAKE256(b"GeneratorsChain" || label) squeezed in
    64-byte blocks, each block -> RistrettoPoint::from_uniform_bytes.

The reference always uses party_capacity = 1.

Generator *expansion* (uniform bytes -> points) is pure precompute; it is
cached on disk, and runs on the device the caller names
(ops/ristretto_device.points_from_uniform_bytes: the host's formulas in
batched field ops, so the points equal RistrettoPoint.from_uniform_bytes's
to the coordinate), since large circuits need 2^20+ generators and one
host map takes 0.29 ms on an H100 machine's host CPU (2^21 points: ~10
minutes in one process, ~80 s in eight; PERF.md).
"""
import hashlib
import os
import pickle
import threading

from .ristretto import RistrettoPoint, RISTRETTO_BASEPOINT

# inside the package (git ignores it), so a run writes nothing outside its
# checkout
_CACHE_DIR = os.environ.get(
    "BPG_TORCH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "_cache"))


class _CombTable:
    """Fixed-base comb: 32 byte-windows of 255 precomputed multiples.
    mul(k) = sum over windows of table[w][byte_w(k)] — at most 32 point
    additions (no doublings) instead of the ~380-op double-and-add ladder.

    Every Pedersen commitment the prover makes (witness/derived commits at
    reference src/gadget.rs:32 and the five T_i commits inside
    prover.prove) hits this path twice; the ~11x host speedup is a direct
    per-witness serving-latency win (docs/PERFORMANCE.md round 5)."""

    __slots__ = ("windows",)

    def __init__(self, point: RistrettoPoint):
        self.windows = []
        base = point
        for _ in range(32):
            row = [base]                       # row[d-1] = d * 256^w * point
            cur = base
            for _ in range(2, 257):
                cur = cur + base
                row.append(cur)
            self.windows.append(row)
            base = row[255]                    # 256 * base

    def mul(self, k: int) -> RistrettoPoint:
        acc = None
        for w, row in enumerate(self.windows):
            d = (k >> (8 * w)) & 0xFF
            if d:
                p = row[d - 1]
                acc = p if acc is None else acc + p
        return acc if acc is not None else RistrettoPoint.identity()


class PedersenGens:
    """pc_gens: commitment v*B + blinding*B_blinding."""

    __slots__ = ("B", "B_blinding", "_comb_B", "_comb_Bb")

    _default = None

    def __init__(self, B=None, B_blinding=None):
        self.B = B or RISTRETTO_BASEPOINT
        if B_blinding is None:
            h = hashlib.sha3_512(self.B.compress()).digest()
            B_blinding = RistrettoPoint.from_uniform_bytes(h)
        self.B_blinding = B_blinding
        self._comb_B = None
        self._comb_Bb = None

    @classmethod
    def default(cls) -> "PedersenGens":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    def commit(self, value, blinding) -> RistrettoPoint:
        """value, blinding: core.scalar.Scalar"""
        if self._comb_B is None:
            self._comb_B = _CombTable(self.B)
            self._comb_Bb = _CombTable(self.B_blinding)
        from .scalar import L as _L
        return (self._comb_B.mul(value.v % _L)
                + self._comb_Bb.mul(blinding.v % _L))


class _GeneratorsChain:
    """SHAKE256-based deterministic point chain (dalek GeneratorsChain)."""

    def __init__(self, label: bytes):
        self._shake = hashlib.shake_256(b"GeneratorsChain" + label)
        self._offset = 0

    def take(self, n: int, device):
        """The next n points, mapped on `device` in batches
        (ops/ristretto_device.points_from_uniform_bytes)."""
        from ..ops.ristretto_device import points_from_uniform_bytes
        # hashlib's XOF cannot stream, so squeeze the full prefix each time;
        # callers monotonically extend, so this is called once per size bump.
        total = self._offset + n
        stream = self._shake.digest(64 * total)
        out = points_from_uniform_bytes(stream[64 * self._offset:], device)
        self._offset = total
        return out


class BulletproofGens:
    """bp_gens with party_capacity fixed at 1 (all reference call sites)."""

    _lock = threading.Lock()
    _cached = None  # (capacity, G, H) — grows monotonically, process-wide

    def __init__(self, gens_capacity: int, party_capacity: int = 1, *,
                 device):
        """A chain that is not cached yet is mapped on `device` ("cuda",
        "cpu", ...)."""
        assert party_capacity == 1, "reference uses party capacity 1 only"
        self.gens_capacity = gens_capacity
        self._ensure(gens_capacity, device)

    @classmethod
    def _disk_load(cls, capacity: int):
        path = os.path.join(_CACHE_DIR, "bp_gens.pkl")
        try:
            with open(path, "rb") as f:
                cap, g_raw, h_raw = pickle.load(f)
            if cap >= capacity:
                G = [RistrettoPoint(*t) for t in g_raw]
                H = [RistrettoPoint(*t) for t in h_raw]
                return cap, G, H
        except (OSError, EOFError, pickle.PickleError):
            pass
        return None

    @classmethod
    def _disk_store(cls, capacity, G, H):
        try:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            path = os.path.join(_CACHE_DIR, "bp_gens.pkl")
            tmp = path + f".tmp{os.getpid()}"
            g_raw = [(p.X, p.Y, p.Z, p.T) for p in G]
            h_raw = [(p.X, p.Y, p.Z, p.T) for p in H]
            with open(tmp, "wb") as f:
                pickle.dump((capacity, g_raw, h_raw), f)
            os.replace(tmp, path)
        except OSError:
            pass

    @classmethod
    def _ensure(cls, capacity: int, device):
        with cls._lock:
            if cls._cached is not None and cls._cached[0] >= capacity:
                return
            loaded = cls._disk_load(capacity)
            if loaded is not None:
                cls._cached = loaded
                return
            g_chain = _GeneratorsChain(b"G" + (0).to_bytes(4, "little"))
            h_chain = _GeneratorsChain(b"H" + (0).to_bytes(4, "little"))
            G = g_chain.take(capacity, device)
            H = h_chain.take(capacity, device)
            cls._cached = (capacity, G, H)
            if capacity >= 256:
                cls._disk_store(capacity, G, H)

    def G(self, n: int):
        assert n <= self.gens_capacity
        return self._cached[1][:n]

    def H(self, n: int):
        assert n <= self.gens_capacity
        return self._cached[2][:n]
