"""Extended twisted-Edwards (a = -1) point operations on limb tensors: the
plain version of the point functions in csrc/field.cuh.

A point is a tuple (X, Y, Z, T) of int64 [NL, ...] carried limb tensors
(ops/fp).  Every function takes the field as `F` (default ops/fp), so
tests/test_torch_bounds.py can run the same op sequences over limb
intervals.  The CUDA point functions follow these sequences op for op.

Counterparts in the JAX package: `_padd_body` and `_madd_body` in
ops/pallas_curve.py; `dbl` is the dedicated doubling of dalek (and of the
JAX package's ops/curve.pdouble), 4 squarings + 4 muls instead of the TPU
Horner's padd(acc, acc); `padd_cached`, the cached form and `inv_fp` are
ops/ipa_fold.py's `_padd_cached_body` and `inv_fp_cols`.
"""
import torch

from . import fp


def identity(shape, device):
    """(0, 1, 1, 0) as carried limbs [NL, *shape]."""
    zero = torch.zeros((fp.NL,) + tuple(shape), dtype=torch.int64,
                       device=device)
    one = zero.clone()
    one[0] = 1
    return (zero, one, one.clone(), zero.clone())


def padd(p, q, F=fp):
    """Unified addition (Hisil et al.; 9 muls)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a, b, tt, zz = F.mul_many(
        [F.sub(y1, x1), F.add(y1, x1), t1, z1],
        [F.sub(y2, x2), F.add(y2, x2), t2, z2])
    c = F.mul(tt, F.d2_like(tt))
    d = F.add(zz, zz)
    return _finish(F, a, b, c, d)


def madd(p, row, F=fp):
    """Mixed addition of an affine operand (x2, y2, t2d) with Z2 = 1 and
    t2d = x2*y2*2d prescaled (7 muls) — the bucket accumulation's step."""
    x1, y1, z1, t1 = p
    x2, y2, t2d = row
    a, b, c = F.mul_many([F.sub(y1, x1), F.add(y1, x1), t1],
                         [F.sub(y2, x2), F.add(y2, x2), t2d])
    d = F.add(z1, z1)
    return _finish(F, a, b, c, d)


def _finish(F, a, b, c, d):
    """The tail shared by padd and madd: e, f, g, h and four muls."""
    e, f, g, h = F.sub(b, a), F.sub(d, c), F.add(d, c), F.add(b, a)
    return tuple(F.mul_many([e, g, f, e], [f, h, g, h]))


def dbl(p, F=fp):
    """Doubling (dbl-2008-hwcd, a = -1; T unused)."""
    x1, y1, z1, _ = p
    s = F.add(x1, y1)
    a, b, zz, xysq = F.mul_many([x1, y1, z1, s], [x1, y1, z1, s])
    c = F.add(zz, zz)
    h = F.add(a, b)
    e, g = F.sub(h, xysq), F.sub(a, b)
    f = F.add(c, g)
    return tuple(F.mul_many([e, g, f, e], [f, h, g, h]))


def to_cached(p, F=fp):
    """Extended point -> cached form (y - x, y + x, 2z, 2d*t) (1 mul)."""
    x, y, z, t = p
    return (F.sub(y, x), F.add(y, x), F.add(z, z), F.mul(t, F.d2_like(t)))


def neg_cached(c, F=fp):
    """The cached form of -P: y - x and y + x swap, 2d*t changes sign."""
    d, s, z2, t2d = c
    return (s, d, z2, F.neg(t2d))


def padd_cached(p, c, F=fp):
    """Extended acc + cached operand (8 muls)."""
    x1, y1, z1, t1 = p
    dc, sc, z2c, t2dc = c
    a, b, cc, d = F.mul_many([F.sub(y1, x1), F.add(y1, x1), t1, z1],
                             [dc, sc, t2dc, z2c])
    return _finish(F, a, b, cc, d)


def inv_fp(z, F=fp):
    """z^(p-2) = 1/z: the curve25519 chain, 254 squarings + 11 muls."""
    def sq_n(x, n):
        for _ in range(n):
            x = F.mul(x, x)
        return x
    z2 = F.mul(z, z)
    z9 = F.mul(sq_n(z2, 2), z)
    z11 = F.mul(z9, z2)
    z_5_0 = F.mul(F.mul(z11, z11), z9)            # z^(2^5 - 1)
    z_10_0 = F.mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = F.mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = F.mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = F.mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = F.mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = F.mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = F.mul(sq_n(z_200_0, 50), z_50_0)
    return F.mul(sq_n(z_250_0, 5), z11)           # 2^255 - 21 = p - 2


def stack(p):
    """Point tuple -> int32 [4, NL, ...] (the kernels' layout)."""
    return torch.stack(p).to(torch.int32)


def unstack(t):
    """int32 [4, NL, ...] -> point tuple of int64 limb tensors."""
    t = t.to(torch.int64)
    return (t[0], t[1], t[2], t[3])


def select(p, idx):
    """Gather lanes along the last axis of every coordinate."""
    return tuple(c[..., idx] for c in p)


def canonical_affine(p):
    """Host check helper: canonical (x, y) ints of each lane, for comparing
    points whose projective representations differ."""
    from ..core.ristretto import P
    xs, ys, zs = (fp.limbs_to_ints(c.reshape(fp.NL, -1)) for c in p[:3])
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out
