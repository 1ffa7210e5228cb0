"""The R1CS prover's polynomial vectors on the device: the port of the JAX
package's ops/prover_device.py.

Everything O(n) between the y/z challenges and the inner-product argument:
the six t-poly inner products (one readback of their nine partial sums)
and the l(x), r(x) build.  l and r stay on the device as the argument's
a and b (ops/ipa_fused.create takes them as they are).

Rows are canonical F_l limbs of ops/fl, [padded_n, NW], std form unless
named _m (Montgomery).  Rows >= n carry the padding the protocol wants:
zeros for the l-parts and r1, r3, and r0 = -y^i, so every function is
uniform over rows.
"""
import torch

from . import fl, flvec
from ..core.scalar import L


def pad_rows(v, padded_n: int, device):
    """Host ints or device rows [n, NW] -> device rows [padded_n, NW],
    zero rows appended."""
    if not isinstance(v, torch.Tensor):
        v = fl.to_limbs([x % L for x in v], device)
    return torch.cat([v, v.new_zeros((padded_n - v.shape[0], fl.NW))])


def upload(vectors, device):
    """k equal-length lists of ints -> device rows [k, n, NW], one copy."""
    k, n = len(vectors), len(vectors[0])
    return fl.to_limbs([x % L for v in vectors for x in v],
                       device).view(k, n, fl.NW)


def commitment_digits(aL, aR, aO, sL, sR, blindings, padded_n: int):
    """Device rows [n, NW] of the witness (aL, aR, aO) and of the blinding
    vectors (sL, sR), and the three blinding scalars (ints) -> int8
    [3*32, 2*padded_n + 2]: the digits of the A_I, A_O and S vectors over
    the table [G | H | B | B_blinding]: [aL | aR | 0 | i], [aO | 0 | 0 | o],
    [sL | sR | 0 | s]."""
    dev = aL.device
    p = lambda v: pad_rows(v, padded_n, dev)                 # noqa: E731
    tail = fl.to_limbs([0, blindings[0] % L, 0, blindings[1] % L,
                        0, blindings[2] % L], dev).view(3, 2, fl.NW)
    zero = aL.new_zeros((padded_n, fl.NW))
    return flvec.digits_t_stacked(torch.stack([
        torch.cat([p(aL), p(aR), tail[0]]),
        torch.cat([p(aO), zero, tail[1]]),
        torch.cat([p(sL), p(sR), tail[2]])]))


class ProverVectors:
    """The witness and constraint vectors on the device (host ints or device
    rows, n each), then the t-poly sums and the l/r build."""

    def __init__(self, aL, aR, aO, sL, sR, wL, wR, wO, y: int, y_inv: int,
                 padded_n: int, device):
        aL, aR, aO, sL, sR, wL, wR, wO = (
            pad_rows(v, padded_n, device)
            for v in (aL, aR, aO, sL, sR, wL, wR, wO))
        self.y_m = flvec.powers_mont(y, padded_n, device)
        self.yinv_m = flvec.powers_mont(y_inv, padded_n, device)
        y_std, yinv_wR, y_aR, y_sR = fl.mont_mul(
            torch.stack([fl.const(1, aL).expand_as(aL), wR, aR, sR]),
            torch.stack([self.y_m, self.yinv_m, self.y_m, self.y_m]))
        # l1 = aL + y^-i wR, l2 = aO, l3 = sL; r0 = wO - y^i,
        # r1 = y^i aR + wL, r3 = y^i sR
        self.l1 = fl.add(aL, yinv_wR)
        self.l2, self.l3 = aO, sL
        self.r0 = flvec.sub(wO, y_std)
        self.r1 = fl.add(y_aR, wL)
        self.r3 = y_sR

    def t_poly(self):
        """The six t-poly coefficients t1..t6 as canonical ints, from one
        readback of the nine inner products."""
        return self.t_poly_from(self.t_poly_device())

    def t_poly_device(self):
        """The nine inner products of the t-poly as device rows [9, NW]."""
        return flvec.inner(
            torch.stack([self.l1, self.l1, self.l2, self.l2, self.l3,
                         self.l1, self.l3, self.l2, self.l3]),
            torch.stack([self.r0, self.r1, self.r0, self.r1, self.r0,
                         self.r3, self.r1, self.r3, self.r3]))

    @staticmethod
    def t_poly_from(parts):
        """t_poly_device's rows, read back -> t1..t6 as canonical ints."""
        i = fl.limbs_to_ints(parts)
        return (i[0], (i[1] + i[2]) % L, (i[3] + i[4]) % L,
                (i[5] + i[6]) % L, i[7], i[8])

    def lr(self, x: int):
        """l(x) = l1 x + l2 x^2 + l3 x^3 and r(x) = r0 + r1 x + r3 x^3 as
        device [padded_n, NW] std rows."""
        xs = flvec.to_mont([x, x * x, x * x * x], self.l1.device)
        p = fl.mont_mul(torch.stack([self.l1, self.l2, self.l3, self.r1,
                                     self.r3]),
                        xs[[0, 1, 2, 0, 2]][:, None])
        return (fl.add(fl.add(p[0], p[1]), p[2]),
                fl.add(fl.add(self.r0, p[3]), p[4]))

    def factors(self, n1: int, u: int):
        """The argument's G and H factors as device Montgomery rows
        [padded_n, NW]: G_i = 1 for i < n1 and u beyond, H_i = y^-i G_i."""
        one_m, u_m = flvec.to_mont([1, u], self.l1.device)
        g = torch.cat([one_m.expand(n1, fl.NW),
                       u_m.expand(self.l1.shape[0] - n1, fl.NW)])
        return g, fl.mont_mul(self.yinv_m, g)
