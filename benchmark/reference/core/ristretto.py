"""Host-side Ristretto255 group (reference semantics, arbitrary-precision ints).

Single-point operations, encode/decode and the constants; the reference
verifier's bulk point math is core/curve_torch.py.

Behavior is pinned to curve25519-dalek 3.2.0 / RFC 9496:
  * CompressedRistretto byte round-trip (.coms file compatibility;
    reference src/lalrpop/assignment_parser.rs:137-138,205)
  * RistrettoPoint::from_uniform_bytes (generator derivation for
    PedersenGens / BulletproofGens)

All constants below are *derived* from p and d rather than transcribed; sign
choices are pinned by the RFC 9496 generator-multiple test vectors in
tests/test_ristretto.py.
"""

P = (1 << 255) - 19
D = (-121665 * pow(121666, P - 2, P)) % P

# sqrt(-1): 2^((p-1)/4) is a square root of -1; RFC 9496 / dalek use the
# "non-negative" one (even canonical encoding).
_c = pow(2, (P - 1) // 4, P)
if _c & 1:
    _c = P - _c
SQRT_M1 = _c
del _c


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _ct_abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int):
    """(was_square, +sqrt(u/v)) per RFC 9496 SQRT_RATIO_M1."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P

    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) % P * SQRT_M1 % P

    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    r = _ct_abs(r)
    return (correct or flipped), r


def _sqrt(x: int) -> int:
    """Square root of a known square (non-negative root)."""
    ok, r = sqrt_ratio_m1(x, 1)
    if not ok:
        raise ValueError("not a square")
    return r


# sqrt(a*d - 1) with a = -1.  RFC 9496 / dalek pin the *negative* (odd) root;
# the elligator output point flips sign with this choice (verified against the
# dalek hash_from_bytes vector in tests/test_ristretto.py).
SQRT_AD_MINUS_ONE = P - _sqrt((-1 - D) % P)
INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)[1]  # 1/sqrt(a - d)
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P


class RistrettoPoint:
    """Extended Edwards coordinates (X:Y:Z:T), x*y = T/Z, on -x^2+y^2=1+d x^2 y^2."""

    __slots__ = ("X", "Y", "Z", "T", "_limbs")

    def __init__(self, X, Y, Z, T):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    # -- group ops --------------------------------------------------------
    @staticmethod
    def identity() -> "RistrettoPoint":
        return RistrettoPoint(0, 1, 1, 0)

    def __add__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        # Unified extended addition (a = -1), Hisil et al.
        A = (self.Y - self.X) * (o.Y - o.X) % P
        B = (self.Y + self.X) * (o.Y + o.X) % P
        C = 2 * D * self.T % P * o.T % P
        Dv = 2 * self.Z * o.Z % P
        E, F, G, H = B - A, Dv - C, Dv + C, B + A
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def double(self) -> "RistrettoPoint":
        A = self.X * self.X % P
        B = self.Y * self.Y % P
        C = 2 * self.Z * self.Z % P
        H = A + B
        E = H - (self.X + self.Y) ** 2 % P
        G = A - B
        F = C + G
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(-self.X % P, self.Y, self.Z, -self.T % P)

    def __sub__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-o)

    def scalar_mul(self, k: int) -> "RistrettoPoint":
        k %= (1 << 256)  # group order divides; double-and-add, host path only
        acc = RistrettoPoint.identity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    def __eq__(self, o) -> bool:
        # Ristretto equality: X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2
        if not isinstance(o, RistrettoPoint):
            return NotImplemented
        return (self.X * o.Y - self.Y * o.X) % P == 0 or \
               (self.Y * o.Y - self.X * o.X) % P == 0

    def __hash__(self):
        return hash(self.compress())

    # -- encoding (RFC 9496 ENCODE) ---------------------------------------
    def compress(self) -> bytes:
        x0, y0, z0, t0 = self.X, self.Y, self.Z, self.T
        u1 = (z0 + y0) * (z0 - y0) % P
        u2 = x0 * y0 % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * t0 % P
        ix0 = x0 * SQRT_M1 % P
        iy0 = y0 * SQRT_M1 % P
        enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
        rotate = _is_negative(t0 * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted_denominator
        else:
            x, y, den_inv = x0, y0, den2
        if _is_negative(x * z_inv % P):
            y = (P - y) % P
        s = _ct_abs(den_inv * ((z0 - y) % P) % P)
        return s.to_bytes(32, "little")

    @staticmethod
    def decompress(b: bytes):
        """RFC 9496 DECODE; returns None on invalid encodings (mirrors
        CompressedRistretto::decompress returning None)."""
        if len(b) != 32:
            return None
        s = int.from_bytes(b, "little")
        if s >= P or (s & 1):
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P * u1) - u2_sqr) % P
        was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = _ct_abs(2 * s % P * den_x % P)
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or _is_negative(t) or y == 0:
            return None
        return RistrettoPoint(x, y, 1, t)

    # -- hash-to-group (RFC 9496 MAP; dalek elligator_ristretto_flavor) ----
    @staticmethod
    def _elligator(t: int) -> "RistrettoPoint":
        r = SQRT_M1 * t % P * t % P
        u = (r + 1) * ONE_MINUS_D_SQ % P
        v = (-1 - r * D) % P * ((r + D) % P) % P
        was_square, s = sqrt_ratio_m1(u, v)
        if was_square:
            c = P - 1
        else:
            s = (P - _ct_abs(s * t % P)) % P
            c = r
        n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
        w0 = 2 * s * v % P
        w1 = n * SQRT_AD_MINUS_ONE % P
        w2 = (1 - s * s) % P
        w3 = (1 + s * s) % P
        return RistrettoPoint(w0 * w3, w2 * w1, w1 * w3, w0 * w2)

    @staticmethod
    def from_uniform_bytes(b: bytes) -> "RistrettoPoint":
        assert len(b) == 64
        mask = (1 << 255) - 1
        r1 = int.from_bytes(b[:32], "little") & mask
        r2 = int.from_bytes(b[32:], "little") & mask
        return RistrettoPoint._elligator(r1) + RistrettoPoint._elligator(r2)


# The Ed25519 basepoint (y = 4/5, x even) is the Ristretto255 generator.
_BASE_Y = 4 * pow(5, P - 2, P) % P
_BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
RISTRETTO_BASEPOINT = RistrettoPoint(
    _BASE_X, _BASE_Y, 1, _BASE_X * _BASE_Y % P)
IDENTITY_COMPRESSED = b"\x00" * 32
