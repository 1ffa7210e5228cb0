"""F_l vectors for the device inner-product argument: the port of the parts of
the JAX package's ops/flvec.py that the fused IPA uses (`to_mont` of host
ints, `sum_rows`, and `digits_device`, the signed c = 8 recode on device;
the other host conversions and `add` are ops/fl's).

Rows are [..., NW] canonical limbs of ops/fl.  The recodes here add a bias
whose base-2^c digits are all 2^(c-1) and read the windows of the sum: if s
has the signed digits d_w in [-2^(c-1), 2^(c-1)), then s + bias has the
unsigned digits d_w + 2^(c-1), so no carry chain runs over the windows.
That gives exactly `ops/msm.signed_digits` (the same digits, uniquely
determined) for every value below 2^256 - bias (about 2^254.99 for c = 8).

Not ported yet (they wait for the device-vector slice): `digits_t_stacked`,
`inner`, `powers_mont` and the c = 13 recode.
"""
import functools

import torch

from . import fl
from .fl import B, NW, R, L, add, mont_mul, to_limbs


def to_mont(values, device="cpu") -> torch.Tensor:
    """Python ints -> Montgomery rows of (v mod l)."""
    return to_limbs([v % L * R % L for v in values], device)


def sum_rows(x):
    """[..., n, NW] canonical -> [..., NW] canonical sum over n (n < 2^26).
    The limb-wise sum carries into an eleventh limb hi; lo + hi * R mod l is
    mont_mul(lo, R mod l) + mont_mul(hi, R^2 mod l)."""
    s = x.sum(-2)
    t = torch.cat([s.reshape(-1, NW).t(),
                   torch.zeros((1, s.numel() // NW), dtype=torch.int64,
                               device=x.device)])
    t = fl.carry(t)
    hi = torch.zeros_like(t[:NW])
    hi[0] = t[NW]
    mults = torch.stack([fl.const(R, x), fl.const(R * R, x)])
    parts = mont_mul(torch.stack([t[:NW].t(), hi.t()]), mults[:, None])
    return add(parts[0], parts[1]).reshape(s.shape)


@functools.lru_cache(maxsize=None)
def _window_plan(width, device):
    """Limb index and shift of each width-bit window of a 256-bit value,
    and the bias whose windows are all 2^(width-1)."""
    nwin = 256 // width
    bits = torch.arange(nwin, dtype=torch.int64) * width
    bias = sum((1 << (width - 1)) << (width * w) for w in range(nwin))
    bias_limbs = torch.tensor([(bias >> (B * j)) & fl.MASK
                               for j in range(NW)], dtype=torch.int64)
    return (bits // B).to(device), (bits % B).to(device)[:, None], \
        bias_limbs.to(device)[:, None]


def windows(x, width: int):
    """[..., NW] rows (value < 2^256 - bias) -> [256/width, ...] int64 window
    values of x + bias, each in [0, 2^width): the signed digit is the value
    minus 2^(width-1)."""
    j, r, bias = _window_plan(width, x.device)
    t = x.reshape(-1, NW).t()
    t = torch.cat([t + bias, torch.zeros_like(t[:1])])   # limb NW stays 0
    t = fl.carry(t)
    word = t[j] | (t[j + 1] << B)
    out = (word >> r) & ((1 << width) - 1)
    return out.reshape((out.shape[0],) + tuple(x.shape[:-1]))


def digits_device(x):
    """[..., NW] rows (value < 2^254) -> [32, ...] int8 signed base-256
    digits, window-leading; equal to ops/msm.signed_digits of the values."""
    return (windows(x, 8) - 128).to(torch.int8)
