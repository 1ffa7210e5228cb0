"""F_l vectors on the device: the port of the JAX package's ops/flvec.py
(`to_mont` of host ints, `sub`, `neg`, `sum_rows`, `inner`, `powers_mont`,
and `digits_device` / `digits_t_stacked`, the signed c = 8 recode on
device; the other host conversions and `add` are ops/fl's).  Used by the
device inner-product argument, the flattening and the prover and verifier
vectors (ops/ipa_fused, flatten, prover_device, verifier_device).

Rows are [..., NW] canonical limbs of ops/fl.  The recodes here add a bias
whose base-2^c digits are all 2^(c-1) and read the windows of the sum: if s
has the signed digits d_w in [-2^(c-1), 2^(c-1)), then s + bias has the
unsigned digits d_w + 2^(c-1), so no carry chain runs over the windows.
That gives exactly `ops/msm.signed_digits` (the same digits, uniquely
determined) for every value below 2^256 - bias (about 2^254.99 for c = 8).

`powers_mont` doubles its prefix ([1] -> [1, z] -> [1, z, z^2, z^3] -> ...)
with one mont_mul per step, log2(count) in all; the JAX package's
associative scan serves XLA's fusion, which eager PyTorch does not have.
Not ported: the c = 13 recode (nothing reaches it below 2^21 points).
"""
import functools

import torch

from . import fl
from .fl import B, NW, R, L, add, mont_mul, to_limbs


def to_mont(values, device="cpu") -> torch.Tensor:
    """Python ints -> Montgomery rows of (v mod l)."""
    return to_limbs([v % L * R % L for v in values], device)


def sub(a, b):
    """(a - b) mod l, canonical; a, b canonical."""
    a, b = torch.broadcast_tensors(a, b)
    x, shape = fl._flat(a - b)
    x = fl.carry(x.clone())                      # value in (-l, l)
    neg = x[NW - 1] < 0
    return fl._unflat(torch.where(
        neg, fl.carry(x + fl._col(fl._L_LIMBS, x.device)), x), shape)


def neg(b):
    """(-b) mod l, canonical; b canonical."""
    return sub(torch.zeros_like(b), b)


def reduce_sums(s):
    """[..., NW] limb sums (non-negative int64 below 2^62) -> canonical
    [..., NW] value mod l.  The carry runs into an eleventh limb hi (below
    2^36); lo + hi * R mod l is mont_mul(lo, R mod l) + mont_mul(hi, R^2
    mod l), hi carried over limbs first."""
    t = torch.cat([s.reshape(-1, NW).t(),
                   torch.zeros((1, s.numel() // NW), dtype=torch.int64,
                               device=s.device)])
    t = fl.carry(t)
    hi = torch.zeros_like(t[:NW])
    hi[0] = t[NW]
    hi = fl.carry(hi)
    mults = torch.stack([fl.const(R, s), fl.const(R * R, s)])
    parts = mont_mul(torch.stack([t[:NW].t(), hi.t()]), mults[:, None])
    return add(parts[0], parts[1]).reshape(s.shape)


def sum_rows(x):
    """[..., n, NW] canonical -> [..., NW] canonical sum over n (n < 2^36)."""
    return reduce_sums(x.sum(-2))


def inner(a, b):
    """[..., n, NW] std rows twice -> [..., NW] <a, b> mod l, canonical:
    sum_rows(a * b / R) times R^2 / R."""
    s = sum_rows(mont_mul(a, b))
    return mont_mul(s, fl.const(R * R, s))


def powers_mont(base: int, count: int, device="cpu"):
    """[count, NW] Montgomery rows of base^0 .. base^(count-1) mod l.
    Step: with p = [base^0 .. base^(h-1)] and m = base^h, one mont_mul of
    [p | m] by m gives [base^h .. base^(2h-1) | base^(2h)]."""
    rows = to_mont([1, base % L], device)
    p, m = rows[:1], rows[1:]
    while p.shape[0] < count:
        out = mont_mul(torch.cat([p, m]), m)
        p, m = torch.cat([p, out[:-1]]), out[-1:]
    return p[:count]


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


def digits_t_stacked(rows):
    """[k, n, NW] canonical rows (k scalar vectors) -> int8 [k*32, n]: the
    signed digits of each vector, window-major, vectors stacked (the
    msm_serial.msm_digits_t layout)."""
    k, n = rows.shape[:2]
    return digits_device(rows).transpose(0, 1).reshape(k * 32, n)
