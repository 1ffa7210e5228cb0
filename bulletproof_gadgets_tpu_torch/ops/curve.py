"""Extended twisted-Edwards (a = -1) point operations on limb tensors: the
plain version of the point functions in csrc/field.cuh.

A point is a tuple (X, Y, Z, T) of int64 [NL, ...] carried limb tensors
(ops/fp).  Every function takes the field as `F` (default ops/fp), so
tests/test_torch_bounds.py can run the same op sequences over limb
intervals.  The CUDA point functions follow these sequences op for op.

Counterparts in the JAX package: `_padd_body` and `_madd_body` in
ops/pallas_curve.py; `dbl` is the dedicated doubling of dalek (and of the
JAX package's ops/curve.pdouble), 4 squarings + 4 muls instead of the TPU
Horner's padd(acc, acc).
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
    xs, ys, zs = (fp.limbs_to_ints(c.reshape(fp.NL, -1).cpu().numpy())
                  for c in p[:3])
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out
