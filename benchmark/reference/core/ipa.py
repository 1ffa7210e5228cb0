"""Inner-product argument, verification side: parsing and the verifier's
scalars, byte/transcript-compatible with bulletproofs::inner_product_proof
(dalek 2.x)."""

from .scalar import Scalar, batch_invert, L
from .transcript import (innerproduct_domain_sep, validate_and_append_point,
                         challenge_scalar, ProofError)


class InnerProductProof:
    __slots__ = ("L_vec", "R_vec", "a", "b")

    def __init__(self, L_vec, R_vec, a: Scalar, b: Scalar):
        self.L_vec = L_vec  # list[bytes] compressed points
        self.R_vec = R_vec
        self.a = a
        self.b = b

    def verification_scalars(self, n: int, transcript):
        """(u_sq, u_inv_sq, s) as ints mod L for the verifier's single
        multiscalar check (dalek InnerProductProof::verification_scalars)."""
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise ProofError("inner product proof too large")
        if n != (1 << lg_n):
            raise ProofError("n does not match proof size")

        innerproduct_domain_sep(transcript, n)

        challenges = []
        for Lb, Rb in zip(self.L_vec, self.R_vec):
            validate_and_append_point(transcript, b"L", Lb)
            validate_and_append_point(transcript, b"R", Rb)
            challenges.append(challenge_scalar(transcript, b"u"))

        allinv, challenges_inv = batch_invert(challenges)
        u_sq = [u.v * u.v % L for u in challenges]
        u_inv_sq = [u.v * u.v % L for u in challenges_inv]

        s = [allinv.v % L]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * u_sq[(lg_n - 1) - lg_i] % L)
        return u_sq, u_inv_sq, s

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        if len(data) % 32 != 0:
            raise ProofError("IPP bytes not a multiple of 32")
        num = len(data) // 32
        if num < 2:
            raise ProofError("IPP too short")
        lg_n = (num - 2) // 2
        if num != 2 * lg_n + 2:
            raise ProofError("IPP malformed")
        if lg_n >= 32:
            raise ProofError("IPP too large")
        L_vec, R_vec = [], []
        for i in range(lg_n):
            L_vec.append(data[64 * i:64 * i + 32])
            R_vec.append(data[64 * i + 32:64 * i + 64])
        a = _from_canonical(data[-64:-32])
        b = _from_canonical(data[-32:])
        return InnerProductProof(L_vec, R_vec, a, b)


def _from_canonical(b32: bytes) -> Scalar:
    """Scalar::from_canonical_bytes: rejects values >= l (FormatError)."""
    v = int.from_bytes(b32, "little")
    if v >= L:
        raise ProofError("non-canonical scalar")
    return Scalar(v)
