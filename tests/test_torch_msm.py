"""The port's device MSM (ops/msm_serial) on the CPU, where every kernel
wrapper runs its plain PyTorch version: whole MSMs against the host
Pippenger `core.msm.msm_host` of the JAX package, a generator table carried
over from the JAX package's `prep_source` rows, and each stage against a
stage reference built with the host group law.  Exact equality.
"""
import random

import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.core.msm import msm_host
from bulletproof_gadgets_tpu.core.ristretto import (
    RistrettoPoint as JaxPoint)
from bulletproof_gadgets_tpu.ops import msm_serial as jax_msm_serial
from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
from bulletproof_gadgets_tpu_torch.core.ristretto import P, RistrettoPoint
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import curve, msm_serial as ms

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def points():
    """The 1026 points of a 512-gens table [G | H | G_0 | G_1]."""
    gens = BulletproofGens(512)
    return list(gens.G(512)) + list(gens.H(512)) + list(gens.G(2))


def _vectors(k, n, seed):
    r = random.Random(seed)
    if k == 1:
        return [[r.randrange(L) for _ in range(n)]]
    # bit vector, all-zero vector, scalars >= L
    return [[r.randrange(2) for _ in range(n)], [0] * n,
            [r.randrange(L, 1 << 256) for _ in range(n)]]


def _as_jax(pts):
    return [JaxPoint(p.X, p.Y, p.Z, p.T) for p in pts]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [1, 3, 50, 130, 1026])
def test_msm_matches_host(points, n, k):
    pts = points[:n]
    src = torch.from_numpy(ms.prep_source(pts))
    vecs = _vectors(k, n, seed=10 * n + k)
    got = ms.msm_many(vecs, src, n)
    want = [msm_host(v, _as_jax(pts)) for v in vecs]
    assert [g.compress() for g in got] == [w.compress() for w in want]


@pytest.mark.parametrize("k", [1, 3])
def test_chunked_msm_matches_host(points, k, monkeypatch):
    """A 258-point table in point chunks of 64 (five chunks, the last of
    two points): the chunks' window sums added lane-wise by K7's plain
    version (four adds) equal the host MSM."""
    n = 258
    pts = points[:n]
    src = torch.from_numpy(ms.prep_source(pts))
    vecs = _vectors(k, n, seed=7 + k)
    adds = []
    real = ms.point_add
    monkeypatch.setattr(ms, "point_add",
                        lambda p, q: adds.append(p.shape) or real(p, q))
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    cols = ms.msm_digits_t(
        torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8)),
        src, n, point_chunk=64)
    assert adds == [(4, ms.NL, k * ms.W)] * 4
    want = [msm_host(v, _as_jax(pts)) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]


def test_table_carried_over_from_jax_rows(points):
    """The JAX package's source rows, converted, are this package's rows,
    and a table built from them gives the host's answer."""
    pts = points[:130]
    rows13, n = jax_msm_serial.prep_source(_as_jax(pts))
    rows = ms.source_from_rows13(np.asarray(rows13))
    assert np.array_equal(rows, ms.prep_source(pts))
    table = ms.GeneratorTable.from_rows(rows, torch.device("cpu"))
    assert table.m == n == 130
    vecs = _vectors(3, n, seed=99)
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    got = table.msm_digits(
        torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8)))
    assert [g.compress() for g in got] == [
        msm_host(v, _as_jax(pts)).compress() for v in vecs]


def _affine(pt):
    zi = pow(pt.Z, P - 2, P)
    return (pt.X * zi % P, pt.Y * zi % P)


def _sum(pts):
    acc = RistrettoPoint.identity()
    for p in pts:
        acc = acc + p
    return acc


def test_stages_match_host_reference(points):
    """Bucket sums, merged bucket sums and window sums of a k=2 MSM with a
    concentrated bit-vector bucket (split over several lanes) equal the
    same sums formed with the host group law."""
    n = 50
    pts = points[:n]
    table = [*pts, *(-p for p in pts), RistrettoPoint.identity()]
    vecs = [[1] * n, _vectors(1, n, seed=4)[0]]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    src = torch.from_numpy(ms.prep_source(pts))
    idx, offs, sub = ms.plan(
        torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8)), n)
    assert int(sub.max()) > 1                     # the bit bucket splits

    pool = ms.bucket_accumulate(src, idx)
    want = [_affine(_sum(table[i] for i in idx[:, lane].tolist()))
            for lane in range(idx.shape[1])]
    assert curve.canonical_affine(curve.unstack(pool)) == want

    buckets = ms.bucket_merge(pool, offs, sub)
    wt = digits.shape[1]
    sums = [[RistrettoPoint.identity() for _ in range(ms.NB)]
            for _ in range(wt)]
    for i in range(n):
        for w in range(wt):
            d = int(digits[i, w])
            if d:
                sums[w][abs(d) - 1] = sums[w][abs(d) - 1] + (
                    pts[i] if d > 0 else -pts[i])
    assert curve.canonical_affine(curve.unstack(buckets)) == [
        _affine(s) for row in sums for s in row]

    ws = ms.window_sums(buckets)
    assert curve.canonical_affine(curve.unstack(ws)) == [
        _affine(_sum(s.scalar_mul(j + 1) for j, s in enumerate(row)))
        for row in sums]


def test_wrappers_check_their_tensors(points):
    src = torch.from_numpy(ms.prep_source(points[:3]))
    idx = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ms.bucket_accumulate(src.long(), idx)
    with pytest.raises(ValueError):
        ms.bucket_accumulate(src[:, :30], idx)
    with pytest.raises(ValueError):
        ms.horner(torch.zeros((4, 10, 64), dtype=torch.int32).transpose(
            1, 2).contiguous().transpose(1, 2), 2)
    with pytest.raises(ValueError):
        ms.window_sums(torch.zeros((4, 10, 100), dtype=torch.int32))
    with pytest.raises(ValueError):                    # row 7 of 7 rows
        ms.bucket_accumulate(src, torch.full((4, 8), 7, dtype=torch.int32))
    pool = torch.zeros((4, 10, 5), dtype=torch.int32)
    with pytest.raises(ValueError):                    # lanes 3..5 of 5
        ms.bucket_merge(pool, torch.tensor([0, 3], dtype=torch.int32),
                        torch.tensor([3, 3], dtype=torch.int32))
    with pytest.raises(ValueError):                    # 3 points, 5 rows
        ms.msm_many([[1, 2, 3]], src[:5], 3)
