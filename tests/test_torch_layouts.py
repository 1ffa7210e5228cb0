"""The pre-transposed bucket layouts of the port's MSM on the CPU, where
every kernel wrapper runs its plain PyTorch version: ops/msm_serial's
`cols` layout (gather_cols, K8 bucket_accumulate_cols, K9
bucket_accumulate_cols_cont) and `flat` layout (gather_flat, K10
bucket_accumulate_flat).

- Against the JAX package's kernels themselves (_bucket_kernel,
  _bucket_kernel_cont, _bucket_kernel2d), called through pl.pallas_call in
  interpret mode with the BlockSpecs its _window_sums_part builds, on the
  same points and the same idx (each lane's entries a prefix of its rounds,
  as a schedule gives them): every lane the same point, and on the lanes
  whose rounds are all entries every pool coordinate equal as a canonical
  value mod p (both packages use the same mixed-add formula; the JAX
  kernels add the identity rows after a lane's entries, which changes its
  extended coordinates, where the port's stop at the first).
- Against K1/K2's plain versions on the same idx: equal limbs.
- Whole MSMs under each layout against the JAX package's host MSM, with
  point chunks and round chunks.
- The pinned proofs under the new layouts through engine.register.
- The wrappers' checks and the engine's layout.
"""
import hashlib
import json
import pathlib
import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bulletproof_gadgets_tpu.core.msm import msm_host
from bulletproof_gadgets_tpu.core.ristretto import RistrettoPoint as JaxPoint
from bulletproof_gadgets_tpu.ops import fp as jfp, msm_serial as jms
from bulletproof_gadgets_tpu.ops.pallas_curve import _SUB_BIAS_COL
from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.core.gens import (BulletproofGens,
                                                     PedersenGens)
from bulletproof_gadgets_tpu_torch.core.ristretto import P
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
from bulletproof_gadgets_tpu_torch.lang.prove import prove
from bulletproof_gadgets_tpu_torch.lang.verify import verify
from bulletproof_gadgets_tpu_torch.ops import engine, fp, msm_serial as ms
from bulletproof_gadgets_tpu_torch.utils import rng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())
T_ROUNDS, LANES, RC = 16, 512, 8    # the JAX kernels' case: rc = 8, one block
KERNELS = {"cols": ("bucket_accumulate_cols", "bucket_accumulate_cols_cont"),
           "flat": ("bucket_accumulate_flat",),
           "rows": ("bucket_accumulate", "bucket_accumulate_cont")}


@pytest.fixture(scope="module")
def points():
    """The 1026 points of a 512-gens table [G | H | G_0 | G_1]."""
    gens = BulletproofGens(512, device="cpu")
    return list(gens.G(512)) + list(gens.H(512)) + list(gens.G(2))


def _as_jax(pts):
    return [JaxPoint(p.X, p.Y, p.Z, p.T) for p in pts]


def _digits_t(vecs):
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    return torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))


def _vectors(n, seed):
    """A bit vector, an all-zero vector and scalars >= L."""
    r = random.Random(seed)
    return [[r.randrange(2) for _ in range(n)], [0] * n,
            [r.randrange(L, 1 << 256) for _ in range(n)]]


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the plain runs of every bucket-accumulation kernel."""
    calls = {}
    for names in KERNELS.values():
        for name in names:
            real = getattr(ms, name + "_plain")

            def spy(*a, _real=real, _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a)
            monkeypatch.setattr(ms, name + "_plain", spy)
    return calls


# -- (1) the plain versions against the JAX kernels --------------------------

def _jax_pool(out):
    """The JAX kernels' four [20, P] outputs -> canonical ints per
    coordinate."""
    return [jfp.from_limbs(np.asarray(c).T) for c in out]


def _port_pool(pool):
    return [fp.limbs_to_ints(pool[c].numpy()) for c in range(4)]


def _specs(blk):
    nl = jfp.NL
    ospec = pl.BlockSpec((nl, blk), lambda j, r: (0, j),
                         memory_space=pltpu.VMEM)
    cspec = pl.BlockSpec((nl, 1), lambda j, r: (0, 0),
                         memory_space=pltpu.VMEM)
    return ospec, cspec


def _out_shape(p):
    return [jax.ShapeDtypeStruct((jfp.NL, p), jnp.int32)] * 4


@partial(jax.jit, static_argnums=(2,))
def _jax_k8(src13, idx, rc):
    """_bucket_kernel on the rounds-leading blocks of _gather_g3."""
    t, p = idx.shape
    blk = jms._blk_for(p)
    ospec, cspec = _specs(blk)
    spec = pl.BlockSpec((rc, jfp.NL, blk), lambda j, r: (r, 0, j),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        partial(jms._bucket_kernel, r_chunk=rc), grid=(p // blk, t // rc),
        in_specs=[cspec] + [spec] * 3, out_specs=[ospec] * 4,
        out_shape=_out_shape(p), interpret=True,
    )(jnp.asarray(_SUB_BIAS_COL), *jms._gather_g3(idx, src13, t, p))


@partial(jax.jit, static_argnums=(3,))
def _jax_k9(src13, idx, acc, rc):
    """_bucket_kernel_cont from the carried pool acc (four [20, P])."""
    t, p = idx.shape
    blk = jms._blk_for(p)
    ospec, cspec = _specs(blk)
    spec = pl.BlockSpec((rc, jfp.NL, blk), lambda j, r: (r, 0, j),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        partial(jms._bucket_kernel_cont, r_chunk=rc),
        grid=(p // blk, t // rc),
        in_specs=[cspec] + [ospec] * 4 + [spec] * 3, out_specs=[ospec] * 4,
        out_shape=_out_shape(p), interpret=True,
    )(jnp.asarray(_SUB_BIAS_COL), *acc, *jms._gather_g3(idx, src13, t, p))


@jax.jit
def _jax_k10(src13, idx):
    """_bucket_kernel2d on the flat [20, T*P] gather, one round per grid
    step (rc = 1)."""
    t, p = idx.shape
    blk = jms._blk_for(p)
    nb = p // blk
    ospec, cspec = _specs(blk)
    g64t = jnp.take(src13, idx.reshape(-1), axis=0).astype(jnp.int32).T
    nl = jfp.NL
    spec = pl.BlockSpec((nl, blk), lambda j, r: (0, r * nb + j),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        jms._bucket_kernel2d, grid=(nb, t), in_specs=[cspec] + [spec] * 3,
        out_specs=[ospec] * 4, out_shape=_out_shape(p), interpret=True,
    )(jnp.asarray(_SUB_BIAS_COL), g64t[0:nl], g64t[nl:2 * nl],
      g64t[2 * nl:3 * nl])


@pytest.fixture(scope="module")
def shared_idx(points):
    """T = 16 rounds over P = 512 lanes of one idx into the rows of 300
    points (both packages' rows: the JAX package's prep_source and the
    port's, carried over); each lane's entries are a prefix of its rounds
    and the identity row fills the rest, as a schedule gives them: half
    the lanes full, the others with 0..16 entries (about a quarter of the
    slots the identity row).  -> (src13, src, idx, full lanes)."""
    pts = points[:300]
    src13, n = jms.prep_source(_as_jax(pts))
    src = torch.from_numpy(ms.source_from_rows13(np.asarray(src13)))
    assert torch.equal(src, torch.from_numpy(ms.prep_source(pts)))
    r = np.random.default_rng(5)
    idx = r.integers(0, 2 * n, size=(T_ROUNDS, LANES), dtype=np.int32)
    live = np.where(r.random(LANES) < 0.5, T_ROUNDS,
                    r.integers(0, T_ROUNDS + 1, LANES))
    idx[np.arange(T_ROUNDS)[:, None] >= live[None, :]] = 2 * n
    return src13, src, idx, live == T_ROUNDS


def _assert_same_pools(got, want, full):
    """Pools as canonical ints per coordinate (_port_pool / _jax_pool):
    every lane the same point, and the full lanes' coordinates equal."""
    def affine(pool):
        return [(x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P)
                for x, y, z in zip(*pool[:3])]
    assert affine(got) == affine(want)
    assert full.sum() > LANES // 3
    for c in range(4):
        assert [v for v, f in zip(got[c], full) if f] == \
            [v for v, f in zip(want[c], full) if f]


def test_cols_plain_matches_jax_bucket_kernel(shared_idx):
    """K8's plain version on gather_cols against _bucket_kernel (rc = 8,
    grid (1, 2)), and K9's plain version over rounds [8, 16) from K8's pool
    over [0, 8) against _bucket_kernel_cont from the JAX K8's pool."""
    src13, src, idx, full = shared_idx
    g = ms.gather_cols(src, torch.from_numpy(idx))
    assert g.shape == (T_ROUNDS, 3 * ms.NL, LANES)
    want = _jax_pool(_jax_k8(src13, jnp.asarray(idx), RC))
    _assert_same_pools(_port_pool(ms.bucket_accumulate_cols(g)), want, full)
    head = _jax_k8(src13, jnp.asarray(idx[:RC]), RC)
    want = _jax_pool(_jax_k9(src13, jnp.asarray(idx[RC:]), tuple(head), RC))
    got = ms.bucket_accumulate_cols_cont(
        g[RC:].contiguous(), ms.bucket_accumulate_cols(g[:RC].contiguous()))
    _assert_same_pools(_port_pool(got), want, full)


def test_flat_plain_matches_jax_bucket_kernel2d(shared_idx):
    src13, src, idx, full = shared_idx
    g = ms.gather_flat(src, torch.from_numpy(idx))
    assert g.shape == (3 * ms.NL, T_ROUNDS * LANES)
    want = _jax_pool(_jax_k10(src13, jnp.asarray(idx)))
    _assert_same_pools(
        _port_pool(ms.bucket_accumulate_flat(g, T_ROUNDS, LANES)), want, full)


# -- (2) against the port's own K1 / K2 --------------------------------------

def test_layouts_equal_rows_plain(points):
    """On one real schedule (k = 3 over 130 points): K8's and K10's plain
    limbs equal K1's, and K8 over [0, t0) then K9 over [t0, T) equals K8
    over [0, T), for every split."""
    n = 130
    src = torch.from_numpy(ms.prep_source(points[:n]))
    idx, _, _ = ms.plan(_digits_t(_vectors(n, seed=21)), n)
    t, p = idx.shape
    assert t >= 4
    whole = ms.bucket_accumulate_plain(src, idx)
    g = ms.gather_cols(src, idx)
    assert torch.equal(ms.bucket_accumulate_cols_plain(g), whole)
    assert torch.equal(
        ms.bucket_accumulate_flat_plain(ms.gather_flat(src, idx), t, p), whole)
    for t0 in range(1, t):
        head = ms.bucket_accumulate_cols_plain(g[:t0].contiguous())
        assert torch.equal(
            ms.bucket_accumulate_cols_cont_plain(g[t0:].contiguous(), head),
            whole)


# -- (3) whole MSMs ----------------------------------------------------------

@pytest.mark.parametrize("layout", ["cols", "flat"])
@pytest.mark.parametrize("point_chunk, slot_budget", [(None, 0), (256, 1)])
def test_msm_under_layout_matches_host(points, layout, point_chunk,
                                       slot_budget, plain_calls):
    """A k = 3 MSM over 258 points under each layout equals the JAX
    package's host MSM, also in point chunks of 256 with a slot budget of
    1 (cols: K8 on round 0, K9's plain version on each later round; flat:
    never round-chunked).  No K1/K2 runs."""
    n = 258
    pts = points[:n]
    src = torch.from_numpy(ms.prep_source(pts))
    vecs = _vectors(n, seed=31)
    cols, _ = ms.msm_digits_t(_digits_t(vecs), src, n,
                              point_chunk=point_chunk,
                              slot_budget=slot_budget, layout=layout)
    want = [msm_host(v, _as_jax(pts)) for v in vecs]
    assert [g.compress() for g in ms.points_from_cols(cols)] == \
        [w.compress() for w in want]
    chunks = -(-n // (point_chunk or n))
    ran = {k: v for k, v in plain_calls.items() if v}
    if layout == "flat":
        assert ran == {"bucket_accumulate_flat": chunks}
    elif slot_budget:
        assert ran["bucket_accumulate_cols"] == chunks
        assert ran["bucket_accumulate_cols_cont"] >= 3 * chunks   # T >= 4
    else:
        assert ran == {"bucket_accumulate_cols": chunks}


# -- (4) the pins under the new layouts --------------------------------------

@pytest.fixture
def registered():
    """engine.register(device, msm_layout=...) for the test, the default
    layout registered again after it."""
    yield lambda layout: engine.register("cpu", msm_layout=layout)
    engine.register("cpu")
    port_msm.set_table_min_size(None)


def _sha(b):
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("layout", ["cols", "flat"])
def test_less_than_pin_under_layout(layout, registered, plain_calls):
    """LESS_THAN (a 1026-point table: commitments, IPA and verifier MSMs on
    the device path) proves byte-equal to its pin with every table MSM in
    the layout registered with the engine, and verifies."""
    registered(layout)
    st = PINS["statements"]["less_than"]
    rng.set_seed(PINS["seed"])
    coms = []
    try:
        proof, _ = prove("less_than", st["instance"], st["witness"],
                         st["gadgets"], coms)
    finally:
        rng.set_seed(None)
    assert _sha(proof) == st["proof_sha256"]
    assert _sha("".join(coms).encode()) == st["coms_sha256"]
    assert verify("less_than", st["instance"], proof, "".join(coms),
                  st["gadgets"])
    ran = {k for k, v in plain_calls.items() if v}
    assert ran == {KERNELS[layout][0]}


def test_batch_pin_under_cols_round_chunks(registered, plain_calls,
                                           monkeypatch):
    """The three 16-bit BOUND witnesses of batch_bound16x3_table under the
    cols layout with a slot budget of 1 (every MSM's rounds one per chunk:
    K8, then K9's plain version) stay byte-equal to the JAX package's
    prove_batch pin."""
    registered("cols")
    monkeypatch.setattr(ms, "SLOT_BUDGET", 1)
    b = PINS["batches"]["batch_bound16x3_table"]
    port_msm.set_table_min_size(b["table_min_size"])
    rng.set_seed(PINS["seed"])
    try:
        results = prove_batch(b["name"], b["instance"], b["witnesses"],
                              b["gadgets"])
    finally:
        rng.set_seed(None)
    assert [_sha(p) for p, _, _ in results] == b["proof_sha256"]
    assert [_sha(c.encode()) for _, _, c in results] == b["coms_sha256"]
    ran = {k for k, v in plain_calls.items() if v}
    assert ran == set(KERNELS["cols"])


# -- (5) wrappers and the engine ---------------------------------------------

def test_layout_wrappers_check_their_tensors(points):
    src = torch.from_numpy(ms.prep_source(points[:3]))
    idx = torch.zeros((4, 8), dtype=torch.int32)
    g = ms.gather_cols(src, idx)
    flat = ms.gather_flat(src, idx)
    acc = ms.bucket_accumulate_cols(g)
    with pytest.raises(TypeError):                     # dtype
        ms.bucket_accumulate_cols(g.long())
    with pytest.raises(TypeError):
        ms.bucket_accumulate_flat(flat.to(torch.int16), 4, 8)
    with pytest.raises(TypeError):
        ms.bucket_accumulate_cols_cont(g, acc.long())
    with pytest.raises(ValueError):                    # shape
        ms.bucket_accumulate_cols(g[:, :20].contiguous())
    with pytest.raises(ValueError):
        ms.bucket_accumulate_cols_cont(g, acc[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        ms.bucket_accumulate_flat(flat, 8, 8)          # 64 of 32 columns
    with pytest.raises(ValueError):
        ms.bucket_accumulate_flat(flat, -4, -8)
    with pytest.raises(ValueError):                    # contiguity
        ms.bucket_accumulate_cols(g.transpose(0, 2).contiguous()
                                  .transpose(0, 2))
    with pytest.raises(ValueError):                    # device
        ms.bucket_accumulate_cols(g.to("meta"))
    with pytest.raises(ValueError):
        ms.bucket_accumulate_flat(flat.to("meta"), 4, 8)
    with pytest.raises(ValueError):                    # mixed devices
        ms.bucket_accumulate_cols_cont(g, acc.to("meta"))


def test_engine_keeps_the_registered_layout(monkeypatch, registered):
    """engine.use(device) keeps the layout registered before; the table
    factory and the generic backend both run in it; an unknown layout
    raises wherever it is given."""
    n = 96                                             # 2n + 2 = 194 points
    gens, pc = BulletproofGens(n, device="cpu"), PedersenGens.default()
    G, H = list(gens.G(n)), list(gens.H(n))
    seen = []
    monkeypatch.setattr(ms, "msm", lambda ks, pts, dev, layout: seen.append(
        (len(ks), dev.type, layout)) or pc.B)
    registered("flat")
    assert engine.use("cpu").type == "cpu"
    assert engine.use().type == "cpu"
    table = port_msm.generator_table(G, H, pc.B, pc.B_blinding)
    assert isinstance(table, ms.GeneratorTable) and table.layout == "flat"
    port_msm.msm([1] * 194, G + H + [pc.B, pc.B_blinding])
    assert seen == [(194, "cpu", "flat")]
    engine.register("cpu")
    rows = port_msm.generator_table(G, H, pc.B, pc.B_blinding)
    assert rows.layout == "rows" and rows is not table
    for bad in (lambda: engine.register("cpu", msm_layout="row"),
                lambda: ms.GeneratorTable(G, H, pc.B, pc.B_blinding, "cpu",
                                          "columns"),
                lambda: ms.msm_digits_t(
                    torch.zeros((ms.W, 1), dtype=torch.int8),
                    torch.zeros((3, ms.ROW), dtype=torch.int32), 1,
                    layout="flat2d")):
        with pytest.raises(ValueError, match="unknown MSM layout"):
            bad()
    assert engine._layout == "rows"
