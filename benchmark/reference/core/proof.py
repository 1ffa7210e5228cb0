"""R1CSProof parsing, byte-layout-identical to bulletproofs::r1cs::R1CSProof
(`.proof` file contract; written at the reference crate's src/prove.rs:81,
read at src/verify.rs:53).

Layout: one version byte (0 = one-phase, 1 = two-phase), then 32-byte
compressed points A_I1, A_O1, S1, [A_I2, A_O2, S2,] T_1, T_3, T_4, T_5, T_6,
then scalars t_x, t_x_blinding, e_blinding, then the IPP (L_i R_i ... a b).
"""

from .scalar import Scalar
from .ristretto import IDENTITY_COMPRESSED
from .transcript import ProofError
from .ipa import InnerProductProof, _from_canonical

ONE_PHASE_COMMITMENTS = 0
TWO_PHASE_COMMITMENTS = 1


class R1CSProof:
    __slots__ = ("A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2",
                 "T_1", "T_3", "T_4", "T_5", "T_6",
                 "t_x", "t_x_blinding", "e_blinding", "ipp_proof")

    def __init__(self, A_I1, A_O1, S1, A_I2, A_O2, S2,
                 T_1, T_3, T_4, T_5, T_6,
                 t_x: Scalar, t_x_blinding: Scalar, e_blinding: Scalar,
                 ipp_proof: InnerProductProof):
        # all points are 32-byte compressed encodings
        self.A_I1, self.A_O1, self.S1 = A_I1, A_O1, S1
        self.A_I2, self.A_O2, self.S2 = A_I2, A_O2, S2
        self.T_1, self.T_3, self.T_4, self.T_5, self.T_6 = T_1, T_3, T_4, T_5, T_6
        self.t_x, self.t_x_blinding, self.e_blinding = t_x, t_x_blinding, e_blinding
        self.ipp_proof = ipp_proof

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        if len(data) % 32 != 1:
            raise ProofError("proof format error")
        version = data[0]
        body = data[1:]
        if version == ONE_PHASE_COMMITMENTS:
            min_points = 3 + 5
        elif version == TWO_PHASE_COMMITMENTS:
            min_points = 6 + 5
        else:
            raise ProofError("unknown proof version")
        num_elems = len(body) // 32
        if num_elems < min_points + 3 + 2:
            # points + 3 scalars + at least (a, b) — mirrors dalek's minlength
            raise ProofError("proof too short")

        def elem(i):
            return body[32 * i:32 * (i + 1)]

        idx = 0
        A_I1, A_O1, S1 = elem(0), elem(1), elem(2)
        idx = 3
        if version == TWO_PHASE_COMMITMENTS:
            A_I2, A_O2, S2 = elem(3), elem(4), elem(5)
            idx = 6
        else:
            A_I2 = A_O2 = S2 = IDENTITY_COMPRESSED
        T_1, T_3, T_4, T_5, T_6 = (elem(idx), elem(idx + 1), elem(idx + 2),
                                   elem(idx + 3), elem(idx + 4))
        idx += 5
        t_x = _from_canonical(elem(idx))
        t_x_blinding = _from_canonical(elem(idx + 1))
        e_blinding = _from_canonical(elem(idx + 2))
        idx += 3
        ipp = InnerProductProof.from_bytes(body[32 * idx:])
        return R1CSProof(A_I1, A_O1, S1, A_I2, A_O2, S2,
                         T_1, T_3, T_4, T_5, T_6,
                         t_x, t_x_blinding, e_blinding, ipp)
