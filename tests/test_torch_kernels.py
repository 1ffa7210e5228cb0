"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the `cuda` fixture, not at import).  The card runs them with

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX, which the GPU machine
does not need).  chip_smoke.py runs the same comparisons at the example
statement's full shapes (K7 on merkle32's chunk window sums).
"""
import random

import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
from bulletproof_gadgets_tpu_torch.core.msm import msm_host
from bulletproof_gadgets_tpu_torch.core.gens import PedersenGens
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import flvec, ipa_fold
from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms

pytestmark = pytest.mark.cuda

N_GENS = 1024          # a 2050-point table


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stage_inputs(cuda):
    """One k=3 MSM's inputs to every stage: a bit vector, a half-zero
    vector and a random one over the first 2050 generators."""
    gens = BulletproofGens(N_GENS)
    pts = list(gens.G(N_GENS)) + list(gens.H(N_GENS)) + list(gens.G(2))
    n = len(pts)
    src = torch.from_numpy(ms.prep_source(pts)).to(cuda)
    r = random.Random(5)
    vecs = [[r.randrange(2) for _ in range(n)],
            [r.randrange(L) if i % 2 else 0 for i in range(n)],
            [r.randrange(L) for _ in range(n)]]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    idx, offs, sub = ms.plan(d.to(cuda), n)
    pool = ms.bucket_accumulate(src, idx)
    buckets = ms.bucket_merge(pool, offs, sub)
    ws = ms.window_sums(buckets)
    return dict(src=src, idx=idx, offs=offs, sub=sub, pool=pool,
                buckets=buckets, ws=ws, k=len(vecs), pts=pts, vecs=vecs)


STAGES = {
    "bucket_accumulate": ("src", "idx"),
    "bucket_merge": ("pool", "offs", "sub"),
    "window_sums": ("buckets",),
    "horner": ("ws", "k"),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_kernel_equals_plain(stage, stage_inputs):
    args = [stage_inputs[a] for a in STAGES[stage]]
    before = ms.LAUNCHES[stage]
    got = getattr(ms, stage)(*args)
    torch.cuda.synchronize()
    assert ms.LAUNCHES[stage] == before + 1
    want = getattr(ms, stage + "_plain")(*args)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, want)          # same limbs, tolerance 0


def test_msm_equals_host(stage_inputs):
    out = ms.horner(stage_inputs["ws"], stage_inputs["k"])
    got = ms.points_from_cols(out)
    want = [msm_host(v, stage_inputs["pts"]) for v in stage_inputs["vecs"]]
    assert [g.compress() for g in got] == [w.compress() for w in want]


def test_wrapper_rejects_bad_tensors(stage_inputs):
    src = stage_inputs["src"]
    with pytest.raises(TypeError):
        ms.bucket_accumulate(src.to(torch.int64), stage_inputs["idx"])
    with pytest.raises(ValueError):
        ms.bucket_accumulate(src, stage_inputs["idx"].t())
    with pytest.raises(ValueError):
        ms.bucket_accumulate(src.cpu(), stage_inputs["idx"])


def test_ladder_fold_equals_plain(cuda, monkeypatch):
    """K6 on a small fold (n_t = 256, d = 4: 2 x 16 outputs of 16 terms)
    against its plain version on the card, through materialize."""
    n_t, d = 256, 4
    gens = BulletproofGens(n_t)
    pc = PedersenGens.default()
    pts = list(gens.G(n_t)) + list(gens.H(n_t)) + [pc.B, pc.B_blinding]
    src = torch.from_numpy(ms.prep_source(pts)).to(cuda)
    r = random.Random(6)
    gc, hc = (flvec.to_mont([r.randrange(L) for _ in range(n_t)], cuda)
              for _ in range(2))
    before = ms.LAUNCHES["ladder_fold"]
    got = ipa_fold.materialize(src, gc, hc, n_t, d, len(pts))
    torch.cuda.synchronize()
    assert ms.LAUNCHES["ladder_fold"] == before + 1
    monkeypatch.setattr(ipa_fold, "ladder_fold", ipa_fold.ladder_fold_plain)
    want = ipa_fold.materialize(src, gc, hc, n_t, d, len(pts))
    assert got.is_cuda and torch.equal(got, want)   # canonical rows, exact


def test_point_add_equals_plain(stage_inputs):
    """K7 on the k=3 MSM's window sums (the chunk combine's width: 96
    lanes) and on its whole bucket pool against its plain version."""
    for p in (stage_inputs["ws"], stage_inputs["pool"]):
        q = p.flip(2).contiguous()
        before = ms.LAUNCHES["point_add"]
        got = ms.point_add(p, q)
        torch.cuda.synchronize()
        assert ms.LAUNCHES["point_add"] == before + 1
        assert got.is_cuda and torch.equal(got, ms.point_add_plain(p, q))


def test_chunked_msm_equals_host(stage_inputs):
    """The k=3 MSM over the 2050-point table in point chunks of 512 (five
    chunks, four K7 launches) equals the host MSM."""
    src, vecs = stage_inputs["src"], stage_inputs["vecs"]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    before = ms.LAUNCHES["point_add"]
    cols = ms.msm_digits_t(d.to(src.device), src, len(stage_inputs["pts"]),
                           point_chunk=512)
    assert ms.LAUNCHES["point_add"] == before + 4
    want = [msm_host(v, stage_inputs["pts"]) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]
