"""Inner-product argument, byte/transcript-compatible with
bulletproofs::inner_product_proof (dalek 2.x, `yoloproofs` feature as pinned
by the reference's Cargo.toml:19-22).

Design — *collapsed folding*: dalek's prover folds the G/H
generator vectors point-by-point every round (O(n) scalar-mults per round on
the CPU).  Here the generators never move: the fold state is carried in
per-generator coefficient vectors gc/hc over F_l (after j rounds the virtual
generator G'_i is sum_{t = i mod n_j} gc[t]*G_t), and each round's L/R is a
single batched MSM over the ORIGINAL generator arrays — which stay resident
on device across all rounds.  With a device table (`supports_digits`) the
coefficient vectors live on the device too and the table is folded every
few rounds (ops/ipa_fused); the host loop below is the oracle for every
other table.  The emitted L/R group elements (and hence compressed bytes
and Fiat-Shamir challenges) are identical to dalek's.
"""

from .scalar import Scalar, batch_invert
from .ristretto import RistrettoPoint
from .transcript import (innerproduct_domain_sep, append_point,
                         validate_and_append_point, challenge_scalar,
                         ProofError)
from .msm import msm


def _inner_product(a, b) -> Scalar:
    acc = Scalar.zero()
    for x, y in zip(a, b):
        acc = acc + x * y
    return acc


class InnerProductProof:
    __slots__ = ("L_vec", "R_vec", "a", "b")

    def __init__(self, L_vec, R_vec, a: Scalar, b: Scalar):
        self.L_vec = L_vec  # list[bytes] compressed points
        self.R_vec = R_vec
        self.a = a
        self.b = b

    @staticmethod
    def create(transcript, Q: RistrettoPoint, G_factors, H_factors,
               G, H, a, b, table=None, w=None) -> "InnerProductProof":
        """Equivalent to InnerProductProof::create (inner_product_proof.rs):
        same transcript ops, same L/R points, same final a/b.

        G, H: lists of RistrettoPoint (length n, power of two); a, b:
        lists of Scalar; G_factors/H_factors: Scalar (dalek's first-round
        unrolled H' = y^-i H multiplication, folded here into the initial
        coefficient vectors).  With a device table, a and b may also be
        device std rows and G_factors/H_factors device Montgomery rows
        (ops/fl, [n, NW]).

        table/w: optional generator table [G | H | B | B_blinding]
        (core.msm.generator_table) whose G/H slots are exactly the G/H
        arguments, plus the Fiat-Shamir scalar w with Q = w*B.  When given,
        each round's L and R are ONE `table.msm_many` call over the
        resident table (the c_L*Q / c_R*Q terms ride the B slot as c*w);
        a device table (`supports_digits`) runs ops/ipa_fused.create.
        """
        n_full = len(G)
        assert n_full == len(H) == len(a) == len(b)
        assert n_full == len(G_factors) == len(H_factors)
        assert n_full & (n_full - 1) == 0, "n must be a power of two"

        innerproduct_domain_sep(transcript, n_full)

        from .scalar import L as _q
        if (table is not None and getattr(table, "supports_digits", False)
                and n_full > 1):
            # Scalar lists go in as ints; the prover's device vectors
            # (ops/prover_device) go in as they are
            from ..ops import ipa_fused
            ints = lambda v: ([s.v % _q for s in v]          # noqa: E731
                              if isinstance(v, list) else v)
            L_vec, R_vec, a0, b0 = ipa_fused.create(
                transcript, table, w.v % _q, ints(G_factors),
                ints(H_factors), ints(a), ints(b))
            return InnerProductProof(L_vec, R_vec, Scalar(a0), Scalar(b0))

        # Hot path: raw-int modular arithmetic (Scalar wrappers only at the
        # transcript boundary).  gc/hc = coefficient of original G_t / H_t
        # inside the current virtual generators.
        gc = [s.v % _q for s in G_factors]
        hc = [s.v % _q for s in H_factors]
        a = [s.v % _q for s in a]
        b = [s.v % _q for s in b]

        w_int = w.v % _q if w is not None else None
        L_vec, R_vec = [], []
        pts_all = None if table is not None else G + H + [Q]
        n = n_full
        while n != 1:
            half = n // 2
            c_L = sum(a[i] * b[half + i] for i in range(half)) % _q
            c_R = sum(a[half + i] * b[i] for i in range(half)) % _q

            # scalar on G_t for L: position pos = t mod n; active when
            # pos >= half with weight a[pos-half]*gc[t]; similarly H/R.
            sGL = [0] * n_full
            sHL = [0] * n_full
            sGR = [0] * n_full
            sHR = [0] * n_full
            for t in range(n_full):
                pos = t % n
                if pos >= half:
                    sGL[t] = a[pos - half] * gc[t] % _q
                    sHR[t] = b[pos - half] * hc[t] % _q
                else:
                    sGR[t] = a[half + pos] * gc[t] % _q
                    sHL[t] = b[half + pos] * hc[t] % _q

            if table is not None:
                vL = sGL + sHL + [c_L * w_int % _q, 0]
                vR = sGR + sHR + [c_R * w_int % _q, 0]
                pL, pR = table.msm_many([vL, vR])
                L = pL.compress()
                R = pR.compress()
            else:
                L = msm(sGL + sHL + [c_L], pts_all).compress()
                R = msm(sGR + sHR + [c_R], pts_all).compress()

            append_point(transcript, b"L", L)
            append_point(transcript, b"R", R)
            L_vec.append(L)
            R_vec.append(R)

            u = challenge_scalar(transcript, b"u").v
            u_inv = pow(u, _q - 2, _q)

            a = [(a[i] * u + u_inv * a[i + half]) % _q for i in range(half)]
            b = [(b[i] * u_inv + u * b[i + half]) % _q for i in range(half)]
            for t in range(n_full):
                if (t % n) < half:
                    gc[t] = gc[t] * u_inv % _q
                    hc[t] = hc[t] * u % _q
                else:
                    gc[t] = gc[t] * u % _q
                    hc[t] = hc[t] * u_inv % _q
            n = half

        return InnerProductProof(L_vec, R_vec, Scalar(a[0]), Scalar(b[0]))

    def verification_challenges(self, n: int, transcript):
        """(u_sq, u_inv_sq, allinv): the transcript-side part of dalek's
        verification_scalars — the O(n) s-vector is built separately (on
        device once ops/verifier_device is ported, here by
        verification_scalars)."""
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
        challenges_sq = [u * u for u in challenges]
        challenges_inv_sq = [u * u for u in challenges_inv]
        return challenges_sq, challenges_inv_sq, allinv

    def verification_scalars(self, n: int, transcript):
        """(u_sq, u_inv_sq, s) for the verifier's single mega-MSM."""
        challenges_sq, challenges_inv_sq, allinv = \
            self.verification_challenges(n, transcript)
        lg_n = len(self.L_vec)

        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            u_lg_i_sq = challenges_sq[(lg_n - 1) - lg_i]
            s.append(s[i - k] * u_lg_i_sq)

        return challenges_sq, challenges_inv_sq, s

    # -- serialization (dalek layout: L0 R0 L1 R1 ... a b) -----------------
    def to_bytes(self) -> bytes:
        out = bytearray()
        for Lb, Rb in zip(self.L_vec, self.R_vec):
            out += Lb
            out += Rb
        out += self.a.as_bytes()
        out += self.b.as_bytes()
        return bytes(out)

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
    from .scalar import L as _L
    if v >= _L:
        raise ProofError("non-canonical scalar")
    return Scalar(v)
