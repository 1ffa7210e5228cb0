"""Scalar field F_l, l = 2^252 + 27742317777372353535851937790883648493
(the Ristretto255 group order), semantics-compatible with
curve25519-dalek 3.2.0 `Scalar` as used by the reference crate.

dalek subtlety preserved here: `Scalar::from_bits` (reference
src/conversions.rs:18,43) stores *raw* little-endian bytes with only bit 255
masked — the value may exceed l and `as_bytes` returns it unreduced.  Any
arithmetic produces a canonical (reduced) result.  We model that by keeping
the raw integer in `Scalar.v` and reducing in the operators.
"""

L = (1 << 252) + 27742317777372353535851937790883648493

_MASK_255 = (1 << 255) - 1


class Scalar:
    __slots__ = ("v",)

    def __init__(self, v: int):
        # The stored value is whatever the construction path produced;
        # from_bits may leave it >= L (but < 2^255).
        self.v = v

    # -- constructors ------------------------------------------------------
    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    @staticmethod
    def one() -> "Scalar":
        return Scalar(1)

    @staticmethod
    def from_int(v: int) -> "Scalar":
        return Scalar(v % L)

    @staticmethod
    def from_bits(b: bytes) -> "Scalar":
        assert len(b) == 32
        return Scalar(int.from_bytes(b, "little") & _MASK_255)

    @staticmethod
    def from_bytes_mod_order_wide(b: bytes) -> "Scalar":
        assert len(b) == 64
        return Scalar(int.from_bytes(b, "little") % L)

    # -- encoding ----------------------------------------------------------
    def as_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    @property
    def canonical(self) -> int:
        return self.v % L

    # -- arithmetic (always reduces) --------------------------------------
    # Non-Scalar operands return NotImplemented so LinearCombination's
    # reflected operators take over (Scalar +/- LC appears in gadget code).
    def __add__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar((self.v + other.v) % L)

    def __sub__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar((self.v - other.v) % L)

    def __mul__(self, other):
        if not isinstance(other, Scalar):
            return NotImplemented
        return Scalar((self.v * other.v) % L)

    def __neg__(self) -> "Scalar":
        return Scalar((-self.v) % L)

    def invert(self) -> "Scalar":
        return Scalar(pow(self.v % L, L - 2, L))

    def __eq__(self, other) -> bool:
        # dalek Scalar PartialEq compares bytes (raw representation); every
        # reference call site compares post-arithmetic (canonical) values,
        # except from_bits round-trip tests which compare equal raws anyway.
        return isinstance(other, Scalar) and self.v == other.v

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"Scalar(0x{self.v:064x})"


def batch_invert(scalars):
    """Montgomery's trick; mirrors dalek Scalar::batch_invert.

    Returns (product_of_inverses, list_of_inverses).
    """
    n = len(scalars)
    prefix = [1] * (n + 1)
    for i, s in enumerate(scalars):
        prefix[i + 1] = (prefix[i] * (s.v % L)) % L
    total_inv = pow(prefix[n], L - 2, L)
    inv = [None] * n
    acc = total_inv
    for i in range(n - 1, -1, -1):
        inv[i] = Scalar((acc * prefix[i]) % L)
        acc = (acc * (scalars[i].v % L)) % L
    return Scalar(total_inv), inv
