"""The port's plain F_p and point ops (bulletproof_gadgets_tpu_torch.ops.fp,
ops.curve) against the JAX package's field and point bodies
(ops/pallas_curve._mul, _padd_body, _madd_body, each under one jax.jit on
jnp arrays, no pallas_call), its lane-wise add kernel `padd_cols` (Pallas,
interpret mode on the CPU) and the host group law (core/ristretto).

Inputs come from numpy seeds and go to both sides as Python ints; results
are compared as canonical values (field elements) or canonical affine
coordinates (points: the projective representations differ between the two
layouts).  Tolerance: exact equality.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.ops import fp as jfp, pallas_curve as pc
from bulletproof_gadgets_tpu_torch.core.ristretto import (
    P, D, RISTRETTO_BASEPOINT, RistrettoPoint)
from bulletproof_gadgets_tpu_torch.ops import curve, fp
from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms

torch.set_num_threads(1)

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bulletproof_gadgets_tpu_torch", "csrc", "field.cuh")

# 0, 1, p-1, p-2, values near 2^255 and 2^254, a high-limb-only value
EDGES = [0, 1, 2, 19, P - 1, P - 2, P - 20, (1 << 254), (1 << 254) - 1,
         (1 << 230), (1 << 255) - 1 - P]


def _rand(seed, n):
    raw = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") % P
            for i in range(n)]


def _port(values):
    return torch.from_numpy(fp.ints_to_limbs(values)).to(torch.int64)


def _jax(values):
    return jnp.asarray(jfp.ints_to_limbs_cols(values))


def _jax_ints(cols):
    return fp.limbs_to_ints(fp.limbs13_to_limbs(np.asarray(cols)))


@pytest.mark.parametrize("seed", [0, 1])
def test_field_ops_match_jax(seed):
    a = _rand(seed, 40) + EDGES
    b = _rand(seed + 100, 40) + EDGES[::-1]
    pa, pb = _port(a), _port(b)
    ja, jb = _jax(a), _jax(b)
    bias = jnp.asarray(pc._SUB_BIAS_COL)
    want = [x * y % P for x, y in zip(a, b)]
    assert fp.limbs_to_ints(fp.mul(pa, pb).numpy()) == want
    assert _jax_ints(jax.jit(pc._mul)(ja, jb)) == want
    lazy = jax.jit(pc._lazy)
    for port_out, jax_out, ref in (
            (fp.add(pa, pb), lazy(ja + jb), [x + y for x, y in zip(a, b)]),
            (fp.sub(pa, pb), lazy(ja + bias - jb),
             [x - y for x, y in zip(a, b)])):
        got = fp.canonical(port_out)
        assert got.numpy().tolist() == fp.ints_to_limbs(
            _jax_ints(jax_out)).tolist()
        assert fp.limbs_to_ints(got.numpy()) == [v % P for v in ref]


def test_canonical_and_conversions_at_edges():
    vals = EDGES + _rand(7, 30)
    limbs = fp.ints_to_limbs(vals)
    assert fp.limbs_to_ints(limbs) == [v % P for v in vals]
    assert np.array_equal(
        fp.canonical(torch.from_numpy(limbs).to(torch.int64)).numpy(), limbs)
    # non-canonical limb vectors: every limb at its top (value 2^255 - 1),
    # every limb at the carried extremes, and mixed signs
    w = np.array(fp.W)
    raw = np.stack([(1 << w) - 1, (1 << (w - 1)), -(1 << (w - 1)),
                    np.where(np.arange(10) % 2, 1 << 26, -(1 << 26)),
                    np.full(10, -1)], axis=1).astype(np.int64)      # [10, 5]
    ints = fp.limbs_to_ints(raw)
    assert fp.canonical(torch.from_numpy(raw)).numpy().tolist() == \
        fp.ints_to_limbs(ints).tolist()
    prod = fp.mul(torch.from_numpy(raw), torch.from_numpy(raw[:, ::-1].copy()))
    assert fp.limbs_to_ints(prod.numpy()) == [
        x * y % P for x, y in zip(ints, ints[::-1])]
    # the JAX package's 13-bit limb columns convert both ways
    cols = jfp.ints_to_limbs_cols(vals)
    assert np.array_equal(fp.limbs13_to_limbs(cols), limbs)
    assert np.array_equal(fp.limbs_to_limbs13(limbs), cols)


def _points(seed, n):
    r = np.random.default_rng(seed)
    pts = [RISTRETTO_BASEPOINT.scalar_mul(int(k))
           for k in r.integers(1, 1 << 62, n)]
    return pts + [RistrettoPoint.identity()]


def _affine(pt):
    zi = pow(pt.Z, P - 2, P)
    return (pt.X * zi % P, pt.Y * zi % P)


def _port_pts(pts):
    return tuple(_port([getattr(p, c) for p in pts]) for c in "XYZT")


def _jax_pts(pts):
    return tuple(_jax([getattr(p, c) for p in pts]) for c in "XYZT")


def _jax_affine(out):
    xs, ys, zs = (_jax_ints(c) for c in out[:3])
    return [(x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P)
            for x, y, z in zip(xs, ys, zs)]


def test_point_ops_match_jax_and_host():
    p = _points(3, 6)
    # pairs: random, P + P, P + (-P), identity on either side
    q = _points(4, 6)[:3] + [p[3], -p[4], p[0]] + [p[1]]
    bias = jnp.asarray(pc._SUB_BIAS_COL)
    d2 = jnp.asarray(pc._D2_COL)
    padd_body, madd_body = jax.jit(pc._padd_body), jax.jit(pc._madd_body)

    want = [_affine(a + b) for a, b in zip(p, q)]
    assert curve.canonical_affine(curve.padd(_port_pts(p), _port_pts(q))) \
        == want
    assert _jax_affine(padd_body(bias, d2, *_jax_pts(p),
                                 *_jax_pts(q))) == want

    aff = [_affine(b) for b in q]
    t2d = [x * y * 2 * D % P for x, y in aff]
    row_port = (_port([a[0] for a in aff]), _port([a[1] for a in aff]),
                _port(t2d))
    row_jax = (_jax([a[0] for a in aff]), _jax([a[1] for a in aff]),
               _jax(t2d))
    assert curve.canonical_affine(curve.madd(_port_pts(p), row_port)) == want
    assert _jax_affine(madd_body(bias, *_jax_pts(p), *row_jax)) == want

    dbl_want = [_affine(a.double()) for a in p]
    assert curve.canonical_affine(curve.dbl(_port_pts(p))) == dbl_want
    assert _jax_affine(padd_body(bias, d2, *_jax_pts(p),
                                 *_jax_pts(p))) == dbl_want


def test_point_add_plain_matches_jax_padd_cols():
    """K7's plain version (msm_serial.point_sum on CPU tensors) over two
    chunks against the JAX package's padd_cols on one 512-lane block
    (Pallas interpret mode) and the host group law: lane i adds p[i % 7]
    and q[(3 i) % 7]."""
    p, q = _points(5, 6), _points(6, 6)[::-1]
    lanes = np.arange(512)
    pp = [p[i % 7] for i in lanes]
    qq = [q[3 * i % 7] for i in lanes]
    got = ms.point_sum(torch.stack([curve.stack(_port_pts(pp)),
                                    curve.stack(_port_pts(qq))]))
    assert got.dtype == torch.int32 and got.shape == (4, fp.NL, 512)
    want = [_affine(a + b) for a, b in zip(pp, qq)]
    assert curve.canonical_affine(curve.unstack(got)) == want
    assert _jax_affine(pc.padd_cols(_jax_pts(pp), _jax_pts(qq))) == want


def test_cuda_header_matches_plain_constants():
    """csrc/field.cuh hard-codes 2d and the carry order; they must be the
    plain version's."""
    src = open(HEADER).read()
    body = re.search(r"fe_d2\(\) \{\s*fe r = \{\{([^}]*)\}\}", src).group(1)
    assert [int(v) for v in body.split(",")] == fp.D2
    carry = src[src.index("fe_carry(int64_t h[10])"):
                src.index("__device__ __forceinline__ fe fe_mul")]
    order = []
    for m in re.finditer(r"BPG_CARRY\(h, (\d), (\d+)\)|h\[9\] -= c", carry):
        if m.group(1) is None:
            order.append(9)
        else:
            order.append(int(m.group(1)))
            assert int(m.group(2)) == fp.W[int(m.group(1))]
    assert tuple(order) == fp.CARRY_ORDER
