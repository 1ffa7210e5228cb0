"""The verifier's table-MSM scalars on the device: the port of the JAX
package's ops/verifier_device.py.

dalek's verifier folds everything into one multiscalar multiplication; the
O(n) scalars on the generator table (the IPA s-vector and the g/h
per-generator coefficients) are built here and returned as signed digits
for msm_serial.msm_digits_t.  The host supplies only O(log n) values: the
challenges, and the B and B_blinding coefficients (which fold in delta,
read back by the caller as one row).

Rows are canonical F_l limbs of ops/fl ([n, NW], std unless named _m).
"""
import torch

from . import fl, flvec
from .prover_device import pad_rows
from ..core.scalar import L


def _s_vector(allinv_m, u_sq_m):
    """The IPA verification s-vector, std rows [2^lg_n, NW]: s[0] =
    allinv, s[i + 2^j] = s[i] * u_sq[lg_n - 1 - j].  allinv_m: [NW]
    Montgomery; u_sq_m: [lg_n, NW] Montgomery."""
    lg_n = u_sq_m.shape[0]
    s = fl.from_mont(allinv_m[None, :])
    for j in range(lg_n):
        s = torch.cat([s, fl.mont_mul(s, u_sq_m[lg_n - 1 - j])])
    return s


def table_digits_dev(ynw_d, wL_d, wO_d, yinv_m, x: int, a: int, b: int,
                     u: int, allinv: int, u_sq, n: int, n1: int,
                     padded_n: int, c_B: int, c_Bb: int):
    """Digits int8 [32, 2*padded_n + 2] of the verifier's table vector
    [g_scalars | h_scalars | c_B | c_Bb]:

      g_i = u_or_1[i] * (x * ynw[i] - a * s[i])
      h_i = u_or_1[i] * (y^-i * (x * wL[i] + wO[i] - b * s[padded_n-1-i]) - 1)

    ynw_d = wR[i] * y^-i, wL_d, wO_d: device std rows [n, NW]; yinv_m:
    Montgomery rows [padded_n, NW] of y^-i; u_or_1 is 1 for i < n1 and u
    beyond; u_sq: the lg_n squared IPA challenges."""
    dev = wL_d.device
    wL, wO, ynw = (pad_rows(v, padded_n, dev) for v in (wL_d, wO_d, ynw_d))
    one_m, u_m, x_m, a_m, b_m, allinv_m = flvec.to_mont(
        [1, u, x, a, b, allinv], dev)
    u1_m = torch.cat([one_m.expand(n1, fl.NW),
                      u_m.expand(padded_n - n1, fl.NW)])
    u_sq_m = flvec.to_mont([v % L for v in u_sq], dev)
    tail = fl.to_limbs([c_B % L, c_Bb % L], dev)

    s = _s_vector(allinv_m, u_sq_m)
    x_ynw, a_s, x_wL, b_s = fl.mont_mul(
        torch.stack([ynw, s, wL, s.flip(0)]),
        torch.stack([x_m, a_m, x_m, b_m])[:, None])
    g = fl.mont_mul(flvec.sub(x_ynw, a_s), u1_m)
    h_in = flvec.sub(fl.add(x_wL, wO), b_s)
    h = fl.mont_mul(flvec.sub(fl.mont_mul(h_in, yinv_m),
                              fl.const(1, h_in)), u1_m)
    return flvec.digits_device(torch.cat([g, h, tail]))
