"""R1CS verifier (dalek bulletproofs::r1cs::Verifier, one phase), reduced to
the scalars of its single multiscalar check.

`Verifier.equation` runs the verifier's transcript and returns the check as
scalars: one per point of the generator table [G | H | B | B_blinding] and
one per proof point.  The proof is valid iff the sum of scalar times point
is the identity; `reference.verify` evaluates that sum (core/curve_torch)
for many proofs at once.
"""

from .scalar import Scalar, L as L_MOD
from .lc import (Variable, to_lc, COMMITTED, MULT_LEFT, MULT_RIGHT, MULT_OUT)
from .transcript import (r1cs_domain_sep, r1cs_1phase_domain_sep,
                         append_point, append_scalar,
                         validate_and_append_point, challenge_scalar)


class R1CSError(Exception):
    pass


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class Verifier:
    """bulletproofs::r1cs::Verifier equivalent (1-phase)."""

    def __init__(self, transcript):
        self.transcript = transcript
        self.constraints = []
        self.num_vars = 0       # multiplier count
        self.V = []             # compressed commitments
        r1cs_domain_sep(transcript)

    def get_num_vars(self) -> int:
        return self.num_vars

    def commit(self, commitment: bytes) -> Variable:
        i = len(self.V)
        self.V.append(commitment)
        append_point(self.transcript, b"V", commitment)
        return Variable(COMMITTED, i)

    def multiply(self, left, right):
        left = to_lc(left).clone()
        right = to_lc(right).clone()
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable(MULT_LEFT, i)
        r_var = Variable(MULT_RIGHT, i)
        o_var = Variable(MULT_OUT, i)
        left.terms.append((l_var, -Scalar.one()))
        right.terms.append((r_var, -Scalar.one()))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate_multiplier(self, _assignment=None, _bit_source=None):
        i = self.num_vars
        self.num_vars += 1
        return (Variable(MULT_LEFT, i), Variable(MULT_RIGHT, i),
                Variable(MULT_OUT, i))

    def constrain(self, lc):
        self.constraints.append(to_lc(lc))

    def _flattened_constraints(self, z: int):
        """(wL, wR, wO, wV, wc) as ints mod L."""
        n = self.num_vars
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * len(self.V)
        wc = 0
        exp_z = z
        for lc in self.constraints:
            for var, coeff in lc.terms:
                c = exp_z * coeff.v
                kind = var.kind
                if kind == MULT_LEFT:
                    wL[var.index] += c
                elif kind == MULT_RIGHT:
                    wR[var.index] += c
                elif kind == MULT_OUT:
                    wO[var.index] += c
                elif kind == COMMITTED:
                    wV[var.index] -= c
                else:  # One()
                    wc -= c
            exp_z = exp_z * z % L_MOD
        return ([x % L_MOD for x in wL], [x % L_MOD for x in wR],
                [x % L_MOD for x in wO], [x % L_MOD for x in wV],
                wc % L_MOD)

    def equation(self, proof, r: int):
        """(padded_n, table scalars [2 * padded_n + 2], proof scalars,
        proof points as 32-byte encodings) of the check, with the
        verifier's random weight r; raises R1CSError / ProofError where
        dalek's verify returns Err before its final check."""
        t = self.transcript
        t.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        validate_and_append_point(t, b"A_I1", proof.A_I1)
        validate_and_append_point(t, b"A_O1", proof.A_O1)
        validate_and_append_point(t, b"S1", proof.S1)

        r1cs_1phase_domain_sep(t)
        n = self.num_vars
        padded_n = _next_pow2(n)

        append_point(t, b"A_I2", proof.A_I2)
        append_point(t, b"A_O2", proof.A_O2)
        append_point(t, b"S2", proof.S2)

        y = challenge_scalar(t, b"y").v % L_MOD
        z = challenge_scalar(t, b"z").v % L_MOD

        validate_and_append_point(t, b"T_1", proof.T_1)
        validate_and_append_point(t, b"T_3", proof.T_3)
        validate_and_append_point(t, b"T_4", proof.T_4)
        validate_and_append_point(t, b"T_5", proof.T_5)
        validate_and_append_point(t, b"T_6", proof.T_6)

        u = challenge_scalar(t, b"u").v % L_MOD
        x = challenge_scalar(t, b"x").v % L_MOD

        append_scalar(t, b"t_x", proof.t_x)
        append_scalar(t, b"t_x_blinding", proof.t_x_blinding)
        append_scalar(t, b"e_blinding", proof.e_blinding)

        w = challenge_scalar(t, b"w").v % L_MOD

        ipp = proof.ipp_proof
        a, b = ipp.a.v, ipp.b.v
        t_x, t_x_bl = proof.t_x.v, proof.t_x_blinding.v
        e_bl = proof.e_blinding.v
        y_inv = pow(y, L_MOD - 2, L_MOD)

        wL, wR, wO, wV, wc = self._flattened_constraints(z)
        u_sq, u_inv_sq, s = ipp.verification_scalars(padded_n, t)

        xx = x * x % L_MOD
        xxx = xx * x % L_MOD
        rxx = r * xx % L_MOD

        g_scalars = [0] * padded_n
        h_scalars = [0] * padded_n
        delta = 0
        yi = 1
        for i in range(padded_n):
            u_or_1 = 1 if i < n1 else u
            if i < n:
                ynw = wR[i] * yi % L_MOD
                delta += ynw * wL[i]
                g = x * ynw - a * s[i]
                h = yi * (x * wL[i] + wO[i] - b * s[padded_n - 1 - i]) - 1
            else:
                g = -a * s[i]
                h = yi * (-b * s[padded_n - 1 - i]) - 1
            g_scalars[i] = u_or_1 * g % L_MOD
            h_scalars[i] = u_or_1 * h % L_MOD
            yi = yi * y_inv % L_MOD
        delta %= L_MOD

        table = g_scalars + h_scalars + [
            (w * (t_x - a * b) + r * (xx * (wc + delta) - t_x)) % L_MOD,
            (-e_bl - r * t_x_bl) % L_MOD]

        dyn_scalars = ([x, xx, xxx, u * x % L_MOD, u * xx % L_MOD,
                        u * xxx % L_MOD]
                       + [v * rxx % L_MOD for v in wV]
                       + [r * x % L_MOD, r * xxx % L_MOD,
                          r * x * xxx % L_MOD, r * xx * xxx % L_MOD,
                          r * xxx * xxx % L_MOD]
                       + u_sq + u_inv_sq)
        dyn_points = ([proof.A_I1, proof.A_O1, proof.S1, proof.A_I2,
                       proof.A_O2, proof.S2] + list(self.V)
                      + [proof.T_1, proof.T_3, proof.T_4, proof.T_5,
                         proof.T_6]
                      + list(ipp.L_vec) + list(ipp.R_vec))
        return padded_n, table, dyn_scalars, dyn_points
