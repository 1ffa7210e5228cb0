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
from bulletproof_gadgets_tpu_torch.ops import curve, fp, msm_serial as ms

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def points():
    """The 1026 points of a 512-gens table [G | H | G_0 | G_1]."""
    gens = BulletproofGens(512, device="cpu")
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
    version (one call over the five) equal the host MSM."""
    n = 258
    pts = points[:n]
    src = torch.from_numpy(ms.prep_source(pts))
    vecs = _vectors(k, n, seed=7 + k)
    adds = []
    real = ms.point_sum
    monkeypatch.setattr(ms, "point_sum",
                        lambda ws: adds.append(ws.shape) or real(ws))
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    cols, excess = ms.msm_digits_t(
        torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8)),
        src, n, point_chunk=64)
    assert int(excess) <= 0
    assert adds == [(5, 4, ms.NL, k * ms.W)]
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


def _digits_t(vecs):
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    return torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))


def test_cont_plain_continues_plain(points):
    """K2's plain version over rounds [t0, T) started from K1's plain pool
    over [0, t0) gives K1's limbs over all T rounds, for every split."""
    n = 130
    src = torch.from_numpy(ms.prep_source(points[:n]))
    idx, _, _ = ms.plan(_digits_t(_vectors(3, n, seed=21)), n)
    whole = ms.bucket_accumulate_plain(src, idx)
    assert idx.shape[0] >= 4
    for t0 in range(1, idx.shape[0]):
        head = ms.bucket_accumulate_plain(src, idx[:t0].contiguous())
        got = ms.bucket_accumulate_cont_plain(src, idx[t0:].contiguous(),
                                              head)
        assert torch.equal(got, whole)


@pytest.mark.parametrize("name", [
    "bucket_accumulate", "bucket_accumulate_cont", "bucket_accumulate_cols",
    "bucket_accumulate_cols_cont", "bucket_accumulate_flat"])
def test_accumulation_writes_canonical_limbs(points, name):
    """K1, K2 and K8-K10 (their plain versions here) write the canonical
    limbs of each coordinate, as their kernels do; K2 and K9 refuse a
    carried pool with a limb outside [0, 2^w) (their kernels read it by
    shifts)."""
    n = 130
    src = torch.from_numpy(ms.prep_source(points[:n]))
    idx, _, _ = ms.plan(_digits_t(_vectors(3, n, seed=22)), n)
    t, p = idx.shape
    head = ms.bucket_accumulate(src, idx[:1].contiguous())
    g = ms.gather_cols(src, idx)
    args = {"bucket_accumulate": (src, idx),
            "bucket_accumulate_cont": (src, idx, head),
            "bucket_accumulate_cols": (g,),
            "bucket_accumulate_cols_cont": (g, head),
            "bucket_accumulate_flat": (ms.gather_flat(src, idx), t, p)}[name]
    out = getattr(ms, name)(*args)
    flat = out.reshape(4 * fp.NL, -1).numpy().reshape(4, fp.NL, -1)
    for c in range(4):
        assert np.array_equal(flat[c], fp.ints_to_limbs(
            fp.limbs_to_ints(flat[c])))
    if name.endswith("_cont"):
        for bad in (-1, 1 << 26):
            pool = head.clone()
            pool[1, 3, 5] = bad
            with pytest.raises(ValueError):
                getattr(ms, name)(*args[:-1], pool)


@pytest.mark.parametrize("point_chunk", [None, 64])
def test_round_chunked_msm_matches_host(points, point_chunk, monkeypatch):
    """A k=3 MSM over 258 points whose rounds run one per chunk (slot
    budget 1: K1 on round 0, K2's plain version carrying the pool through
    each later round), also in point chunks of 64, equals the JAX
    package's host MSM."""
    n = 258
    pts = points[:n]
    src = torch.from_numpy(ms.prep_source(pts))
    vecs = _vectors(3, n, seed=31)
    conts = []
    real = ms.bucket_accumulate_cont_plain
    monkeypatch.setattr(ms, "bucket_accumulate_cont_plain",
                        lambda s, i, a: conts.append(i.shape) or real(s, i, a))
    cols, _ = ms.msm_digits_t(_digits_t(vecs), src, n,
                              point_chunk=point_chunk, slot_budget=1)
    chunks = -(-n // (point_chunk or n))
    assert len(conts) >= 3 * chunks                  # T >= 4 per chunk
    assert all(shape[0] == 1 for shape in conts)
    want = [msm_host(v, _as_jax(pts)) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]
    # the same MSM with no round chunks and with the default budget
    for budget in (0, None):
        assert torch.equal(ms.msm_digits_t(_digits_t(vecs), src, n,
                                           point_chunk=point_chunk,
                                           slot_budget=budget)[0], cols)


def test_stack_cap_changes_no_point(points, monkeypatch):
    """More stacked vectors than max_stack_k() split along the vector axis
    into launches of at most that many: the same limbs as one launch."""
    n = 130
    src = torch.from_numpy(ms.prep_source(points[:n]))
    vecs = _vectors(3, n, seed=41) + _vectors(1, n, seed=42)
    digits = _digits_t(vecs)
    whole, _ = ms.msm_digits_t(digits, src, n)
    horners = []
    real = ms.horner
    monkeypatch.setattr(ms, "horner",
                        lambda ws, k: horners.append(k) or real(ws, k))
    monkeypatch.setattr(ms, "max_stack_k", lambda: 3)
    assert torch.equal(ms.msm_digits_t(digits, src, n)[0], whole)
    assert horners == [3, 1]


def test_kernel_failures_raise(points, monkeypatch, tmp_path):
    """A kernel whose launch returns a CUDA error raises (and counts), and
    an nvcc that fails makes the build raise: no wrapper falls back to its
    plain version."""
    from bulletproof_gadgets_tpu_torch import native

    class Lib:
        def bpg_bucket_accumulate_cont(self, *args):
            return 719                             # cudaErrorLaunchFailure

    src = torch.from_numpy(ms.prep_source(points[:3]))
    idx = torch.zeros((2, 8), dtype=torch.int32)
    acc = ms.bucket_accumulate(src, idx)
    monkeypatch.setattr(native, "kernels_for", lambda *t: Lib())
    monkeypatch.setattr(native, "stream", lambda t: 0)
    before = ms.LAUNCHES["bucket_accumulate_cont"]
    with pytest.raises(RuntimeError, match="cudaError 719"):
        ms.bucket_accumulate_cont(src, idx, acc)
    assert ms.LAUNCHES["bucket_accumulate_cont"] == before + 1
    monkeypatch.undo()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        native.build()
    with pytest.raises(ValueError):                # a wrong pool shape
        ms.bucket_accumulate_cont(src, idx, acc[:, :, :4].contiguous())


@pytest.mark.parametrize("d", [1, 2, 17])
def test_point_sum_plain_matches_chained_adds(points, d):
    """K7's plain version over d chunks of 40 lanes of table points (chunk
    i holds points i, i + 1, ...; carried limbs from curve.padd) equals
    the lane-wise host sums, as canonical limbs."""
    n = 40
    chunks = []
    for i in range(d):
        pts = points[i:i + n]
        cols = curve.stack(tuple(torch.from_numpy(fp.ints_to_limbs(
            [getattr(p, c) for p in pts]).astype(np.int64))
            for c in "XYZT"))
        # through padd with the identity: carried, not canonical limbs
        ident = curve.identity((n,), "cpu")
        chunks.append(curve.stack(curve.padd(curve.unstack(cols), ident)))
    got = ms.point_sum(torch.stack(chunks))
    assert got.shape == (4, ms.NL, n)
    widths = fp.const([1 << w for w in fp.W], got[0])
    assert bool(((got >= 0) & (got < widths)).all())
    want = []
    for j in range(n):
        s = points[j]
        for i in range(1, d):
            s = s + points[i + j]
        want.append(s)
    assert [g.compress() for g in ms.points_from_cols(got)] == \
        [w.compress() for w in want]
    acc = curve.unstack(chunks[0])
    for c in chunks[1:]:
        acc = curve.padd(acc, curve.unstack(c))
    assert torch.equal(got, curve.stack(tuple(fp.canonical(c) for c in acc)))


def test_msm_digits_enc_matches_host(points):
    """The encoded MSM (msm_digits_enc; GeneratorTable's launch / finish)
    of three vectors over 130 points: the host MSM's compressed points."""
    n = 130
    pts = points[:n]
    vecs = _vectors(3, n, seed=131)
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    src = torch.from_numpy(ms.prep_source(pts))
    enc, excess = ms.msm_digits_enc(d, src, n)
    assert int(excess) <= 0
    assert enc.dtype == torch.uint8 and enc.shape == (3, 32)
    want = [msm_host(v, _as_jax(pts)).compress() for v in vecs]
    assert [bytes(r.tolist()) for r in enc] == want
    table = ms.GeneratorTable.from_rows(ms.prep_source(pts), "cpu")
    assert table.msm_digits_enc_finish(table.msm_digits_enc_launch(d)) == \
        want
