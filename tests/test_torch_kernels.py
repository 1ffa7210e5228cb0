"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the `cuda` fixture, not at import).  The card runs them with

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest imports JAX, which the GPU machine
does not need).  chip_smoke.py runs the same comparisons at the example
statement's full shapes (K7 on merkle32's chunk window sums, K2 and K9 on
a round chunk of merkle32's batched commitments, K8 and K10 on the
example's commitment launch).
"""
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
from bulletproof_gadgets_tpu_torch.core.msm import msm_host
from bulletproof_gadgets_tpu_torch.core.gens import PedersenGens
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import curve, flvec, ipa_fold
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
    gens = BulletproofGens(N_GENS, device="cpu")
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
    # K2's inputs: the rounds after the first two, the pool of the first two
    head = ms.bucket_accumulate(src, idx[:2].contiguous())
    # K8-K10's: the same rounds gathered in the cols and flat layouts
    g_cols = ms.gather_cols(src, idx)
    return dict(src=src, idx=idx, offs=offs, sub=sub, pool=pool,
                buckets=buckets, ws=ws, k=len(vecs), pts=pts, vecs=vecs,
                idx_tail=idx[2:].contiguous(), head=head, g_cols=g_cols,
                g_tail=g_cols[2:].contiguous(),
                g_flat=ms.gather_flat(src, idx), t=idx.shape[0],
                p=idx.shape[1])


STAGES = {
    "bucket_accumulate": ("src", "idx"),
    "bucket_accumulate_cont": ("src", "idx_tail", "head"),
    "bucket_accumulate_cols": ("g_cols",),
    "bucket_accumulate_cols_cont": ("g_tail", "head"),
    "bucket_accumulate_flat": ("g_flat", "t", "p"),
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
    if stage.startswith("bucket_accumulate_"):  # K2, K8-K10: K1's pool
        assert torch.equal(got, stage_inputs["pool"])


@pytest.fixture(scope="module")
def scan_inputs(stage_inputs):
    """K4 and K5 inputs at k = 9 (288 windows: 144 K4 blocks, 9 K5 blocks)
    from the k=3 MSM's real buckets, and all-identity ones."""
    b = stage_inputs["buckets"]
    buckets9 = torch.cat([b, b.flip(2), b.roll(1000, 2)], 2).contiguous()
    n = buckets9.shape[2]
    ident = curve.stack(curve.identity((n,), b.device))
    return {"real": (buckets9, ms.window_sums(buckets9)),
            "identity": (ident, ident[:, :, :n // ms.NB].contiguous())}


@pytest.mark.parametrize("case", ["real", "identity"])
def test_scans_equal_plain_at_k9(scan_inputs, case):
    """K4 and K5 against their plain versions at tolerance 0 on k = 9
    vectors (more than one block of each kernel)."""
    buckets, ws = scan_inputs[case]
    for name, args in (("window_sums", (buckets,)), ("horner", (ws, 9))):
        before = ms.LAUNCHES[name]
        got = getattr(ms, name)(*args)
        torch.cuda.synchronize()
        assert ms.LAUNCHES[name] == before + 1
        assert got.is_cuda and torch.equal(got, getattr(ms, name + "_plain")(
            *args))


def _chip_smoke():
    """chip_smoke.py (repository root) as a module, for its edge_inputs."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ACCUMULATE = ("bucket_accumulate", "bucket_accumulate_cont",
              "bucket_accumulate_cols", "bucket_accumulate_cols_cont",
              "bucket_accumulate_flat")


@pytest.mark.parametrize("lanes", [None, 1 << 16], ids=["edges", "random"])
def test_accumulation_equals_plain_at_field_edges(cuda, lanes):
    """K1, K2, K8, K9 and K10 against their plain versions (tolerance 0)
    on crafted rows and carried pools whose coordinates sit at the edges of
    the radix-2^32 core (chip_smoke.EDGE_VALUES: 0, 1, 19, 38, p - 1,
    p - 38, 2^224 - 1, 2^254 +- 1, 2^32 - 1; every combination as a row),
    and on 2^16 seeded random lanes x 8 rounds; K8's and K10's pools equal
    K1's, K9's equals K2's; one launch each."""
    src, idx, acc = _chip_smoke().edge_inputs(cuda, lanes)
    t, p = idx.shape
    g_cols, g_flat = ms.gather_cols(src, idx), ms.gather_flat(src, idx)
    args = {"bucket_accumulate": (src, idx),
            "bucket_accumulate_cont": (src, idx, acc),
            "bucket_accumulate_cols": (g_cols,),
            "bucket_accumulate_cols_cont": (g_cols, acc),
            "bucket_accumulate_flat": (g_flat, t, p)}
    before = dict(ms.LAUNCHES)
    got = {name: getattr(ms, name)(*args[name]) for name in ACCUMULATE}
    torch.cuda.synchronize()
    for name in ACCUMULATE:
        assert ms.LAUNCHES[name] == before[name] + 1
        assert torch.equal(got[name], getattr(ms, name + "_plain")(
            *args[name])), name
    for name in ("bucket_accumulate_cols", "bucket_accumulate_flat"):
        assert torch.equal(got[name], got["bucket_accumulate"])
    assert torch.equal(got["bucket_accumulate_cols_cont"],
                       got["bucket_accumulate_cont"])


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


@pytest.mark.parametrize("n_t,d", [(256, 4), (148, 2), (208, 4)])
def test_ladder_fold_equals_plain(cuda, monkeypatch, n_t, d):
    """K6 on small folds (n_t = 256, d = 4: 2 x 16 outputs of 16 terms;
    148 / 2: 2 x 37 of 4; 208 / 4: 2 x 13 of 16, odd output counts)
    against its plain version on the card, through materialize."""
    gens = BulletproofGens(n_t, device="cpu")
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


def test_ladder_fold_rejects_too_many_terms(cuda):
    """K6 takes folds of at most MAX_TERMS terms: the wrapper raises for
    more, and launches nothing."""
    k = 2 * ipa_fold.MAX_TERMS
    src = torch.zeros((1, ms.ROW), dtype=torch.int32, device=cuda)
    base = torch.zeros((k, 3), dtype=torch.int32, device=cuda)
    dig = torch.full((64 * k, 3), 8, dtype=torch.int32, device=cuda)
    before = ms.LAUNCHES["ladder_fold"]
    with pytest.raises(ValueError):
        ipa_fold.ladder_fold(src, base, dig)
    assert ms.LAUNCHES["ladder_fold"] == before


# K3 on buckets of these lane counts (the strides' and tree's edges), three
# times over, among empty buckets and unused lanes that set its group width
# G (ops/msm_serial.merge_shape): pool lanes per bucket -> G
MERGE_SUBS = [0, 1, 2, 31, 32, 33, 64, 137] * 3
MERGE_AVG = {1: 4, 4: 40, 32: 300}


@pytest.mark.parametrize("g", sorted(MERGE_AVG))
def test_bucket_merge_equals_plain_on_split_buckets(stage_inputs, g):
    """K3 against its plain version (tolerance 0) on the k=3 MSM's pool
    cut into buckets of MERGE_SUBS lanes, out of order with gaps between
    them, among empty buckets at random offsets, with group width G = g
    (long buckets: 31-137 at G = 1, 137 at G = 4, none at G = 32)
    and more than one block."""
    r = random.Random(8 + g)
    order = list(range(len(MERGE_SUBS)))
    r.shuffle(order)
    offs, subs, lo = [0] * len(MERGE_SUBS), list(MERGE_SUBS), 0
    for b in order:
        lo += r.randrange(1, 4)
        offs[b] = lo
        lo += subs[b]
    p = max(lo, MERGE_AVG[g] * len(subs))
    for _ in range(-(-p // MERGE_AVG[g]) - len(subs)):
        at = r.randrange(len(subs) + 1)
        offs.insert(at, r.randrange(p + 1))
        subs.insert(at, 0)
    assert ms.merge_shape(p, len(subs))[0] == g
    pool = stage_inputs["pool"][:, :, :p].contiguous()
    assert pool.shape[2] == p
    offs = torch.tensor(offs, dtype=torch.int32, device=pool.device)
    sub = torch.tensor(subs, dtype=torch.int32, device=pool.device)
    before = ms.LAUNCHES["bucket_merge"]
    got = ms.bucket_merge(pool, offs, sub)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["bucket_merge"] == before + 1
    assert got.is_cuda and torch.equal(got, ms.bucket_merge_plain(pool, offs,
                                                                  sub))


def test_point_add_equals_plain(stage_inputs):
    """K7 (point_sum) on the k=3 MSM's window sums (the chunk combine's
    width: 96 lanes) and on its whole bucket pool against its plain
    version, over D = 1, 2 and 17 chunks (the lanes flipped and rolled)."""
    for p in (stage_inputs["ws"], stage_inputs["pool"]):
        for d in (1, 2, 17):
            ws = torch.stack([p.roll(3 * i, 2).flip(2) if i % 2 else
                              p.roll(5 * i, 2) for i in range(d)])
            before = ms.LAUNCHES["point_sum"]
            got = ms.point_sum(ws)
            torch.cuda.synchronize()
            assert ms.LAUNCHES["point_sum"] == before + 1
            assert got.is_cuda and torch.equal(got, ms.point_sum_plain(ws))


def test_chunked_msm_equals_host(stage_inputs):
    """The k=3 MSM over the 2050-point table in point chunks of 512 (five
    chunks, one K7 launch) equals the host MSM."""
    src, vecs = stage_inputs["src"], stage_inputs["vecs"]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    before = ms.LAUNCHES["point_sum"]
    cols, excess = ms.msm_digits_t(d.to(src.device), src,
                                   len(stage_inputs["pts"]), point_chunk=512)
    assert int(excess) <= 0
    assert ms.LAUNCHES["point_sum"] == before + 1
    want = [msm_host(v, stage_inputs["pts"]) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]


def test_round_chunked_msm_equals_host(stage_inputs):
    """The k=3 MSM with its rounds one per chunk (slot budget 1: K1 on the
    first round, K2 on each later one) equals the host MSM."""
    src, vecs = stage_inputs["src"], stage_inputs["vecs"]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    before = ms.LAUNCHES["bucket_accumulate_cont"]
    cols, _ = ms.msm_digits_t(d.to(src.device), src,
                              len(stage_inputs["pts"]), slot_budget=1)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["bucket_accumulate_cont"] == \
        before + stage_inputs["idx"].shape[0] - 1
    want = [msm_host(v, stage_inputs["pts"]) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]


@pytest.mark.parametrize("layout", ["cols", "flat"])
def test_msm_under_layout_equals_host(stage_inputs, layout):
    """The k=3 MSM under each layout, in point chunks of 512 and with the
    slot budget at 1 (cols: K8 on each chunk's first round, K9 on each
    later one; flat: one K10 per chunk), equals the host MSM and launches
    no K1/K2."""
    src, vecs = stage_inputs["src"], stage_inputs["vecs"]
    digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    before = dict(ms.LAUNCHES)
    cols, _ = ms.msm_digits_t(d.to(src.device), src,
                              len(stage_inputs["pts"]), point_chunk=512,
                              slot_budget=1, layout=layout)
    torch.cuda.synchronize()
    ran = {k: ms.LAUNCHES[k] - before[k] for k in before
           if ms.LAUNCHES[k] != before[k]}
    chunks = -(-len(stage_inputs["pts"]) // 512)
    if layout == "flat":
        assert ran["bucket_accumulate_flat"] == chunks
    else:
        assert ran["bucket_accumulate_cols"] == chunks
        assert ran["bucket_accumulate_cols_cont"] >= 3 * chunks
    assert not {"bucket_accumulate", "bucket_accumulate_cont"} & set(ran)
    want = [msm_host(v, stage_inputs["pts"]) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]


def _compress_inputs(cuda, stage_inputs):
    """The k=3 MSM's result (carried limbs from K5), the identity and 29
    seeded points with Z != 1: int32 [4, NL, 33] on the card."""
    from bulletproof_gadgets_tpu_torch.core.ristretto import (
        P, RISTRETTO_BASEPOINT, RistrettoPoint)
    from bulletproof_gadgets_tpu_torch.ops import fp
    r = random.Random(33)
    pts = [RistrettoPoint.identity()]
    for _ in range(29):
        q = RISTRETTO_BASEPOINT.scalar_mul(r.randrange(L))
        z = r.randrange(1, P)
        pts.append(RistrettoPoint(q.X * z, q.Y * z, q.Z * z, q.T * z))
    cols = torch.stack([torch.from_numpy(fp.ints_to_limbs(
        [getattr(p, c) for p in pts])) for c in "XYZT"]).to(cuda)
    res = ms.horner(stage_inputs["ws"], stage_inputs["k"])
    return torch.cat([res, cols], 2).contiguous()


def test_ristretto_compress_equals_plain(cuda, stage_inputs):
    """ristretto_compress on the k=3 MSM's points, the identity and random
    points against its plain version (tolerance 0) and the host."""
    from bulletproof_gadgets_tpu_torch.ops import ristretto_device as rd
    cols = _compress_inputs(cuda, stage_inputs)
    before = ms.LAUNCHES["ristretto_compress"]
    got = rd.ristretto_compress(cols)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["ristretto_compress"] == before + 1
    assert got.is_cuda and torch.equal(got, rd.compress_cols(cols))
    want = [p.compress() for p in ms.points_from_cols(cols)]
    assert [bytes(row) for row in got.cpu().numpy()] == want


def test_transcript_round_equals_plain(cuda):
    """transcript_round for three transcripts at three byte positions,
    four chained rounds of seeded encodings, against its plain version
    (states, positions, rows: tolerance 0); challenge_rows on 64 chosen
    byte strings (below and above l, near 2^512) against its plain
    version."""
    from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
    from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript
    rng = np.random.default_rng(3)
    ts = []
    for c in (0, 3, 5):
        t = Transcript(b"R1CSProof")
        for _ in range(c):
            t.append_message(b"V", rng.bytes(32))
        ts.append(t)
    state, meta = sd.snapshot(ts, cuda)
    p_state, p_meta = state.cpu(), meta.cpu()
    for _ in range(4):
        enc = torch.from_numpy(rng.integers(0, 256, (3, 2, 32),
                                            dtype=np.uint8))
        before = ms.LAUNCHES["transcript_round"]
        state, meta, u = sd.transcript_round(state, meta, enc.to(cuda))
        torch.cuda.synchronize()
        assert ms.LAUNCHES["transcript_round"] == before + 1
        p_state, p_meta, p_u = sd.transcript_round_plain(p_state, p_meta,
                                                         enc)
        assert torch.equal(state.cpu(), p_state)
        assert torch.equal(meta.cpu(), p_meta)
        assert torch.equal(u.cpu(), p_u)
    vals = [0, 1, L - 1, L, L + 1, (1 << 256) - 1, 1 << 256, L << 256,
            (1 << 512) - 1, (1 << 512) - L]
    chs = [v.to_bytes(64, "little") for v in vals] + [
        rng.bytes(64) for _ in range(54)]
    ch = torch.tensor([list(c) for c in chs], dtype=torch.uint8)
    before = dict(ms.LAUNCHES)
    got = sd.challenge_rows(ch.to(cuda))
    torch.cuda.synchronize()
    assert ms.LAUNCHES["challenge_rows"] == before["challenge_rows"] + 1
    assert ms.LAUNCHES["transcript_round"] == before["transcript_round"]
    assert torch.equal(got.cpu(), sd.challenge_rows_plain(ch))


@pytest.mark.parametrize("k", [1, 2, 3, 64])
def test_ristretto_compress_at_edges(cuda, k):
    """ristretto_compress on the identity and k - 1 seeded points with
    carried limbs (chip_smoke.edge_points) in one launch, against its
    plain version (tolerance 0) and the host's encodings."""
    from bulletproof_gadgets_tpu_torch.ops import ristretto_device as rd
    cols, want = _chip_smoke().edge_points(k, 100 + k)
    cols = cols.to(cuda)
    before = ms.LAUNCHES["ristretto_compress"]
    got = rd.ristretto_compress(cols)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["ristretto_compress"] == before + 1
    assert torch.equal(got, rd.compress_cols(cols))
    assert [bytes(row) for row in got.cpu().numpy()] == want


@pytest.mark.parametrize("b", [1, 8, 33])
def test_transcript_round_at_edge_positions(cuda, b):
    """transcript_round on b transcripts at chip_smoke's eight byte
    positions (cycled), four chained rounds of seeded encodings, one
    launch each, against its plain version (states, positions, rows:
    tolerance 0)."""
    from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
    smoke = _chip_smoke()
    state, meta = smoke.edge_transcripts(
        cuda, tuple(smoke.EDGE_LENGTHS[i % 8] for i in range(b)))
    p_state, p_meta = state.cpu(), meta.cpu()
    rng = np.random.default_rng(b)
    for _ in range(4):
        enc = torch.from_numpy(rng.integers(0, 256, (b, 2, 32),
                                            dtype=np.uint8))
        before = ms.LAUNCHES["transcript_round"]
        state, meta, u = sd.transcript_round(state, meta, enc.to(cuda))
        torch.cuda.synchronize()
        assert ms.LAUNCHES["transcript_round"] == before + 1
        p_state, p_meta, p_u = sd.transcript_round_plain(p_state, p_meta,
                                                         enc)
        assert torch.equal(state.cpu(), p_state)
        assert torch.equal(meta.cpu(), p_meta)
        assert torch.equal(u.cpu(), p_u)


def test_challenge_rows_on_edge_strings(cuda):
    """challenge_rows on chip_smoke's CHALLENGE_EDGES (0, around l, 2^252,
    2^256 and 2^512) and seeded strings, one launch, against its plain
    version (tolerance 0)."""
    from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
    ch = torch.tensor([list(c) for c in _chip_smoke().challenge_strings(
        40, 40)], dtype=torch.uint8)
    before = dict(ms.LAUNCHES)
    got = sd.challenge_rows(ch.to(cuda))
    torch.cuda.synchronize()
    assert ms.LAUNCHES["challenge_rows"] == before["challenge_rows"] + 1
    assert ms.LAUNCHES["transcript_round"] == before["transcript_round"]
    assert torch.equal(got.cpu(), sd.challenge_rows_plain(ch))


def test_device_ipa_equals_cpu(cuda):
    """ipa_fused.create on a 64-gens table with one fold, on the card and
    on the CPU: equal L/R bytes, a0, b0 and transcript state."""
    from bulletproof_gadgets_tpu_torch.core.transcript import (
        innerproduct_domain_sep)
    from bulletproof_gadgets_tpu_torch.ops import ipa_fused
    from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript
    n, r = 64, random.Random(64)
    pc = PedersenGens.default()
    gens = BulletproofGens(n, device="cpu")
    a = [r.randrange(L) for _ in range(n)]
    b = [r.randrange(L) for _ in range(n)]
    outs, ts = [], []
    for dev in (cuda, torch.device("cpu")):
        table = ms.GeneratorTable(list(gens.G(n)), list(gens.H(n)), pc.B,
                                  pc.B_blinding, dev)
        t = Transcript(b"ipa-on-card")
        innerproduct_domain_sep(t, n)
        outs.append(ipa_fused.create(t, table, 7, [1] * n, [3] * n, a, b,
                                     fold_at=2, fold_min=4))
        ts.append(t)
    assert outs[0] == outs[1]
    assert ts[0].challenge_bytes(b"x", 32) == ts[1].challenge_bytes(b"x", 32)
