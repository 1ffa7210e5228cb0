"""The port's device Ristretto compression and challenge F_l steps on the CPU
(ops/ristretto_device: the plain versions of the compression kernel and of
the transcript kernel's F_l part) against the host oracles (core/ristretto,
Python ints) and the JAX package's ops/ristretto_device, on seeded inputs.
Exact bytes and exact (canonical) limbs.  Mirrors the JAX package's
tests/test_ristretto_device.py; also checks the constants that the CUDA
sources hard-code (csrc/field_l.cuh, csrc/ristretto.cu, csrc/field32.cuh).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.ops import fp as jfp, flvec as jflvec
from bulletproof_gadgets_tpu.ops import ristretto_device as jrd
from bulletproof_gadgets_tpu_torch import native
from bulletproof_gadgets_tpu_torch.core.ristretto import (
    D, INVSQRT_A_MINUS_D, P, RISTRETTO_BASEPOINT, SQRT_M1, RistrettoPoint)
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import fl, fp
from bulletproof_gadgets_tpu_torch.ops import ristretto_device as rd

torch.set_num_threads(1)
CSRC = native.CSRC


def _points(seed, n):
    """The identity, then n - 1 seeded multiples of the base point, each
    scaled by a seeded z (Z != 1)."""
    rng = np.random.default_rng(seed)
    out = [RistrettoPoint.identity()]
    for _ in range(n - 1):
        k = int.from_bytes(rng.bytes(32), "little") % L
        q = RISTRETTO_BASEPOINT.scalar_mul(k)
        z = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        out.append(RistrettoPoint(q.X * z, q.Y * z, q.Z * z, q.T * z))
    return out


def _cols(pts, carried=False):
    """[4, NL, k] int32 limbs; carried: each limb at or above half its
    width lent to the next one (negative limbs, as K5 writes them)."""
    c = np.stack([fp.ints_to_limbs([getattr(p, a) for p in pts])
                  for a in "XYZT"]).astype(np.int64)
    if carried:
        for i in range(fp.NL - 1):
            big = c[:, i] >= 1 << (fp.W[i] - 1)
            c[:, i] -= big << fp.W[i]
            c[:, i + 1] += big
    return torch.from_numpy(c.astype(np.int32))


@pytest.mark.parametrize("carried", [False, True])
def test_compress_matches_host(carried):
    """The identity and 23 random points with Z != 1, canonical or carried
    limbs: RistrettoPoint.compress's bytes; both branches of the
    INVSQRT_A_MINUS_D rotation and of the sign flip are taken."""
    pts = _points(9, 24)
    got = rd.compress_cols(_cols(pts, carried))
    assert got.dtype == torch.uint8 and got.shape == (24, 32)
    assert [bytes(r.tolist()) for r in got] == [p.compress() for p in pts]
    assert got[0].tolist() == [0] * 32
    assert {_branches(p) for p in pts[1:]} == {(0, 0), (0, 1), (1, 0),
                                               (1, 1)}


def _branches(p):
    """(rotate, flip) of RistrettoPoint.compress on p: whether it takes the
    INVSQRT_A_MINUS_D rotation and whether it negates y."""
    from bulletproof_gadgets_tpu_torch.core.ristretto import sqrt_ratio_m1
    u1 = (p.Z + p.Y) * (p.Z - p.Y) % P
    u2 = p.X * p.Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 * u2 % P)
    z_inv = invsqrt * u1 % P * (invsqrt * u2 % P) % P * p.T % P
    rotate = p.T * z_inv % P & 1
    x = p.Y * SQRT_M1 % P if rotate else p.X
    return rotate, x * z_inv % P & 1


def test_compress_matches_jax_compress_cols():
    """Six points through the JAX package's compress_cols (13-bit limbs,
    under jit) and the port's: equal bytes."""
    pts = _points(10, 6)
    cols13 = np.stack([np.stack([jfp.to_limbs_np([getattr(p, a)])[0]
                                 for p in pts], 1) for a in "XYZT"])
    want = np.asarray(jax.jit(jrd.compress_cols)(jnp.asarray(cols13)))
    got = rd.compress_cols(_cols(pts))
    assert got.numpy().astype(np.int64).tolist() == want.tolist()


def test_canonical_bytes_at_edges():
    vals = [0, 1, 19, P - 1, (1 << 255) - 20, (1 << 224) - 1, 1 << 254]
    limbs = torch.from_numpy(fp.ints_to_limbs(vals).astype(np.int64))
    got = rd.canonical_bytes(limbs)
    assert [bytes(r.tolist()) for r in got] == [v.to_bytes(32, "little")
                                                for v in vals]


def test_sqrt_ratio_m1_matches_host():
    from bulletproof_gadgets_tpu_torch.core.ristretto import sqrt_ratio_m1
    rng = np.random.default_rng(12)
    us = [1, 0, 2] + [int.from_bytes(rng.bytes(32), "little") % P
                      for _ in range(5)]
    vs = [1, 1, 3] + [int.from_bytes(rng.bytes(32), "little") % P
                      for _ in range(5)]
    lim = lambda v: torch.from_numpy(                        # noqa: E731
        fp.ints_to_limbs(v).astype(np.int64))
    ok, r = rd.sqrt_ratio_m1(lim(us), lim(vs))
    want = [sqrt_ratio_m1(u, v) for u, v in zip(us, vs)]
    assert ok.tolist() == [w[0] for w in want]
    assert fp.limbs_to_ints(r.numpy()) == [w[1] for w in want]


def test_challenge_limbs_match_jax_and_ints():
    """64-byte strings below and above l and near 2^512: the std row of the
    value mod l (canonical), equal in value to the JAX package's."""
    rng = np.random.default_rng(11)
    vals = [0, L - 1, L, (1 << 256) + 7, (1 << 512) - 1, L << 259] + [
        int.from_bytes(rng.bytes(64), "little") for _ in range(4)]
    raw = [v.to_bytes(64, "little") for v in vals]
    b = torch.tensor([list(r) for r in raw], dtype=torch.uint8)
    got = rd.challenge_limbs(b)
    assert torch.equal(got, fl.to_limbs([v % L for v in vals]))
    jfn = jax.jit(jrd.challenge_limbs)
    for r, v in zip(raw[:3], vals[:3]):
        j = np.asarray(jfn(jnp.asarray(np.frombuffer(r, np.uint8)
                                       .astype(np.int32))))
        assert jflvec.limbs_to_ints(j[None, :])[0] == v % L


def test_inv_mont_matches_jax_and_fermat():
    """u^(l-2) in Montgomery form against pow and the JAX package's
    inv_mont (values; its R is 2^273)."""
    from bulletproof_gadgets_tpu.ops.fl import R as JAX_R
    rng = np.random.default_rng(13)
    us = [1, 2, L - 1] + [int.from_bytes(rng.bytes(32), "little") % L
                          for _ in range(3)]
    got = rd.inv_mont(fl.to_limbs(us))
    assert torch.equal(got, fl.to_limbs([pow(u, L - 2, L) * fl.R % L
                                         for u in us]))
    assert torch.equal(rd.to_mont_dev(fl.to_limbs(us)),
                       fl.to_limbs([u * fl.R % L for u in us]))
    j = np.asarray(jax.jit(jrd.inv_mont)(jnp.asarray(
        jflvec.to_limbs([us[3]]))[0]))
    assert jflvec.limbs_to_ints(j[None, :])[0] == \
        pow(us[3], L - 2, L) * JAX_R % L


def test_compress_wrapper_on_cpu_runs_the_plain_version():
    pts = _points(14, 3)
    before = dict(native.LAUNCHES)
    got = rd.ristretto_compress(_cols(pts))
    assert native.LAUNCHES == before
    assert [bytes(r.tolist()) for r in got] == [p.compress() for p in pts]
    assert rd.ristretto_compress(_cols(pts)[:, :, :0]).shape == (0, 32)
    with pytest.raises(TypeError):
        rd.ristretto_compress(_cols(pts).to(torch.int64))


def _words(v):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _header_words(src, fn):
    body = re.search(fn + r"\(\) \{(?:\s*//[^\n]*)?\s*f\w+ r = "
                     r"(?:BPG_FL8\(|\{\{)([^;]*?)(?:\)|\}\});", src,
                     re.S).group(1)
    return [int(v.strip().rstrip("u"), 16) for v in body.split(",")]


def test_cuda_sources_match_plain_constants():
    """The constants csrc/field_l.cuh, csrc/ristretto.cu and
    csrc/field32.cuh hard-code: l, -l^-1 mod 2^32, 2^512, 2^768, 2^256
    and 2^260 mod l; l's signed-30 limbs and l^-1 mod 2^30 (the divsteps
    inversion); sqrt(-1), 1/sqrt(-1 - d), 2d."""
    fl_src = open(os.path.join(CSRC, "field_l.cuh")).read()
    for fn, v in (("fl8_l", L), ("fl8_r2", (1 << 512) % L),
                  ("fl8_r3", (1 << 768) % L),
                  ("fl8_one_mont", (1 << 256) % L),
                  ("fl8_r260", (1 << 260) % L)):
        assert _header_words(fl_src, fn) == _words(v), fn
    lp = int(re.search(r"kFlLPrime = (0x[0-9a-f]+)u", fl_src).group(1), 16)
    assert lp == (-pow(L, -1, 1 << 32)) % (1 << 32)
    limbs = re.search(r"s30_l\(\) \{\s*s30 r = \{\{([^}]*)\}\};",
                      fl_src).group(1)
    assert [int(v, 0) for v in limbs.split(",")] == [
        (L >> (30 * i)) & ((1 << 30) - 1) for i in range(8)] + [L >> 240]
    inv30 = int(re.search(r"kFlLInv30 = (0x[0-9a-f]+)u", fl_src).group(1),
                16)
    assert inv30 == pow(L, -1, 1 << 30)
    r_src = open(os.path.join(CSRC, "ristretto.cu")).read()
    assert _header_words(r_src, "fe8_sqrt_m1") == _words(SQRT_M1)
    assert _header_words(r_src, "fe8_invsqrt_a_minus_d") == \
        _words(INVSQRT_A_MINUS_D)
    f32_src = open(os.path.join(CSRC, "field32.cuh")).read()
    assert _header_words(f32_src, "fe8_d2") == _words(2 * D % P)
