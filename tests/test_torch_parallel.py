"""The port's scale-out layer (parallel/) on the CPU: ranks in spawned
processes over gloo, each with the port on device="cpu" (the kernels' plain
versions), a file-store rendezvous under the test's tmp_path and a finite
process-group timeout.  Every rank returns its results; the tests assert
that all ranks agree and that the result equals the target: the pins of
tests/port_pins.json (frozen from the JAX package), the port's one-device
GeneratorTable and the JAX package's host MSM.  The JAX package's own
parallel tests run shard_map on an 8-device CPU mesh and are `slow`; here
only its pure-Python exchange plan is called live.

Each world runs once per module (one spawn per world size, the three at
once) under its own time limit (distributed.run_ranks kills the ranks and
raises when a rank fails or the limit passes), so a divergence fails in
seconds.
"""
import concurrent.futures
import datetime
import hashlib
import json
import pathlib
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.core.gens import (BulletproofGens,
                                                     PedersenGens)
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import engine, ipa_fused, msm_serial
from bulletproof_gadgets_tpu_torch.parallel import (distributed, sharded_ipa,
                                                    mesh as mesh_mod)
from bulletproof_gadgets_tpu_torch.parallel.sharded_serial import \
    ShardedGeneratorTable
from bulletproof_gadgets_tpu_torch.utils import rng

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())
SPAWN_LIMIT = 150.0                       # s per world, start to results
PG_TIMEOUT = datetime.timedelta(seconds=30)
MSM_GENS = 64                             # a 130-point table


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def _msm_vectors(m):
    """k = 2 twice: random and all-zero, one scalar repeated and >= L."""
    r = random.Random(13)
    return [[[r.randrange(L) for _ in range(m)], [0] * m],
            [[r.randrange(L)] * m, [r.randrange(L, 4 * L) for _ in range(m)]]]


# ---------------------------------------------------------------------------
# what each rank runs (module level: the spawned ranks import it by name)

def _gens(n):
    pc = PedersenGens.default()
    gens = BulletproofGens(n, device="cpu")
    return gens.G(n), gens.H(n), pc.B, pc.B_blinding


def _job_msm(mesh):
    """The sharded table's MSMs: msm_many, msm_digits_enc, and a table made
    by from_rows, as compressed points."""
    pts = _gens(MSM_GENS)
    table = ShardedGeneratorTable(*pts, mesh)
    out = [[p.compress() for p in table.msm_many(v)]
           for v in _msm_vectors(table.m)]
    rows = msm_serial.prep_source(list(pts[0]) + list(pts[1]) + list(pts[2:]))
    from_rows = ShardedGeneratorTable.from_rows(rows, mesh)
    vecs = _msm_vectors(table.m)[1]
    digits = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [msm_serial.signed_digits([x % L for x in v], msm_serial.C)
         for v in vecs], axis=1).T))
    out.append(from_rows.msm_digits_enc_finish(
        from_rows.msm_digits_enc_launch(digits)))
    return out


def _statement(name, seeded=True, tamper=True):
    """Prove and verify one pinned statement through lang.prove /
    lang.verify with the mesh active; counts the arguments by route."""
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    st = PINS["statements"][name]
    runs = {"sharded": 0, "fused": 0}
    real_sharded, real_fused = sharded_ipa.create, ipa_fused.create

    traffic = mesh_mod.active_mesh().traffic
    calls = {}

    def spy(kind, fn):
        def call(*a, **kw):
            runs[kind] += 1
            before = {k: v[0] for k, v in traffic.items()}
            out = fn(*a, **kw)
            calls.update({k: v[0] - before.get(k, 0)
                          for k, v in traffic.items()})
            return out
        return call
    sharded_ipa.create = spy("sharded", real_sharded)
    ipa_fused.create = spy("fused", real_fused)
    try:
        rng.set_seed(PINS["seed"] if seeded else None)
        coms = []
        try:
            proof, _ = prove(name, st["instance"], st["witness"],
                             st["gadgets"], coms)
        finally:
            rng.set_seed(None)
        coms = "".join(coms)
        ok = verify(name, st["instance"], proof, coms, st["gadgets"])
        bad = None
        if tamper:
            flipped = bytearray(proof)
            flipped[len(flipped) // 2] ^= 1
            bad = verify(name, st["instance"], bytes(flipped), coms,
                         st["gadgets"])
    finally:
        sharded_ipa.create, ipa_fused.create = real_sharded, real_fused
    return {"proof": _sha(proof), "coms": _sha(coms.encode()),
            "verify": ok, "tampered": bad, "runs": runs,
            "argument_collectives": calls}


def _job_batch(mesh):
    from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
    b = PINS["batches"]["batch_bound16x3_table"]
    port_msm.set_table_min_size(b["table_min_size"])
    rng.set_seed(PINS["seed"])
    try:
        results = prove_batch(b["name"], b["instance"], b["witnesses"],
                              b["gadgets"])
    finally:
        rng.set_seed(None)
        port_msm.set_table_min_size(8)
    return {"proof": [_sha(p) for p, _, _ in results],
            "coms": [_sha(c.encode()) for _, _, c in results]}


def _job_factory(mesh):
    """engine.table_factory under a one-shard mesh (the world as the batch
    axis), under the world's two-shard mesh, and under a second two-shard
    mesh: classes, and whether each mesh's table is cached."""
    pts = _gens(8)
    one = mesh_mod.make_mesh(n_shard=1, n_batch=2, device="cpu",
                             timeout=PG_TIMEOUT)
    other = mesh_mod.make_mesh(device="cpu", timeout=PG_TIMEOUT)
    tables = []
    try:
        for m in (one, mesh, mesh, other):
            mesh_mod.activate(m)
            tables.append(engine.table_factory(*pts, "cpu", "rows"))
    finally:
        mesh_mod.activate(mesh)
    return {"classes": [type(t).__name__ for t in tables],
            "same": [tables[1] is tables[2], tables[2] is tables[3]]}


def _job_collectives(mesh):
    """all_gather, all_reduce (sum, max) and a multicast exchange."""
    d, me = mesh.shape["shard"], mesh.index["shard"]
    x = torch.arange(6, dtype=torch.int64).view(2, 3) + 10 * me
    src_of = [(s + 1) % d if s else d - 1 for s in range(d)]
    src_of[0] = src_of[1]                     # two ranks read one rank
    return {"gather": mesh_mod.all_gather(mesh, x).tolist(),
            "sum": mesh_mod.all_reduce(mesh, x, "sum").tolist(),
            "max": mesh_mod.all_reduce(mesh, x, "max").tolist(),
            "exchange": mesh_mod.exchange(mesh, x, src_of).tolist(),
            "src_of": src_of}


def _rank_suite(rank, world, jobs):
    torch.set_num_threads(1)
    engine.register("cpu")
    port_msm.set_table_min_size(8)
    mesh = mesh_mod.make_mesh(device="cpu", timeout=PG_TIMEOUT)
    mesh_mod.activate(mesh)
    out = {}
    for job in jobs:
        if job == "msm":
            out[job] = _job_msm(mesh)
        elif job == "layout":
            out[job] = ShardedGeneratorTable(*_gens(MSM_GENS),
                                             mesh).cols_host.tolist()
        elif job == "unseeded":
            out[job] = _statement("bound16", seeded=False, tamper=False)
        elif job in PINS["statements"]:
            out[job] = _statement(job)
        else:
            out[job] = globals()[f"_job_{job}"](mesh)
    return out


def _rank_fails(rank, world):
    torch.set_num_threads(1)
    if rank == 1:
        raise ValueError("rank 1 stops before its collective")
    t = torch.zeros(1)
    dist.all_reduce(t)                        # rank 0 waits here
    return 0


# ---------------------------------------------------------------------------
# the worlds (one spawn each) and the references

WORLDS = {2: ["msm", "bound16", "unseeded", "less_than", "batch", "factory"],
          3: ["msm", "bound16", "collectives", "layout"],
          4: ["msm", "bound16"]}


def _agreed(ranks, job):
    """The ranks' one result of `job`: all ranks must agree."""
    assert all(r[job] == ranks[0][job] for r in ranks), job
    return ranks[0][job]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's results of each world's jobs, {world size: [rank's
    results]}: one spawn per world, the three at once."""
    stores = {w: str(tmp_path_factory.mktemp(f"ranks{w}") / "store")
              for w in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(distributed.run_ranks, _rank_suite, w,
                               stores[w], args=(jobs,), timeout=SPAWN_LIMIT,
                               pg_timeout=PG_TIMEOUT)
                for w, jobs in WORLDS.items()}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def msm_references():
    """Per vector pair: the port's GeneratorTable and the JAX package's
    host MSM (over the same points, decompressed by the JAX package)."""
    from bulletproof_gadgets_tpu.core.msm import msm_host as jax_msm_host
    from bulletproof_gadgets_tpu.core.ristretto import \
        RistrettoPoint as JaxPoint
    pts = _gens(MSM_GENS)
    table = msm_serial.GeneratorTable(*pts, "cpu")
    flat = list(pts[0]) + list(pts[1]) + list(pts[2:])
    jax_pts = [JaxPoint.decompress(p.compress()) for p in flat]
    one_device, host = [], []
    for vecs in _msm_vectors(table.m):
        one_device.append([p.compress() for p in msm_serial.msm_many(
            vecs, table.src, table.m)])
        host.append([jax_msm_host(v, jax_pts).compress() for v in vecs])
    return one_device, host


# ---------------------------------------------------------------------------
# tests

@pytest.mark.parametrize("d", [2, 3, 4])
def test_sharded_msm_matches_one_device_and_host(d, worlds, msm_references):
    """ShardedGeneratorTable on a 64-gens table (m = 130), k = 2, random /
    all-zero and one repeated scalar / scalars >= L, at D = 2, 3, 4 (3
    and 4 cut uneven slices): the points of one device and of the JAX
    package's host MSM, on every rank; a table from_rows gives the
    second pair's encodings too."""
    res = _agreed(worlds[d], "msm")
    one_device, host = msm_references
    assert res[:2] == one_device == host
    assert res[2] == one_device[1]


def test_shard_layout_covers_the_table(worlds):
    """D = 3 over 64 generators: rank d's columns are G and H rows
    d*64//3 .. (d+1)*64//3 - 1 (21, 21, 22 of them) and the last rank's
    also B and B_blinding: together the table, once."""
    cols = [r["layout"] for r in worlds[3]]
    assert cols == [list(range(lo, hi)) + list(range(64 + lo, 64 + hi))
                    + ([128, 129] if hi == 64 else [])
                    for lo, hi in ((0, 21), (21, 42), (42, 64))]


@pytest.mark.parametrize("d", [2, 4])
def test_bound16_shards_its_argument(d, worlds):
    """bound16 on a forced device table at D = 2 and 4 (n_loc = 16, 8):
    proof and .coms equal the pin on every rank, verify true, a flipped
    byte false; the argument ran sharded, never on ops/ipa_fused."""
    st = PINS["statements"]["bound16"]
    res = _agreed(worlds[d], "bound16")
    # 5 rounds: one exchange (a swap in round 0, an all-gather after it),
    # the c all-reduce, the window sums' all-gather, the excess all-reduce;
    # then a0, b0 from shard 0
    assert res == {"proof": st["proof_sha256"], "coms": st["coms_sha256"],
                   "verify": True, "tampered": False,
                   "runs": {"sharded": 1, "fused": 0},
                   "argument_collectives": {"exchange": 1, "all_gather": 10,
                                            "all_reduce": 10}}
    assert sharded_ipa.shards(st["gens"], d)


def test_bound16_replicated_vectors(worlds):
    """D = 3 does not divide n = 32: the argument's vectors are replicated
    on every rank, its MSMs still sharded; the bytes equal the pin."""
    st = PINS["statements"]["bound16"]
    assert not sharded_ipa.shards(st["gens"], 3)
    assert _agreed(worlds[3], "bound16") == {
        "proof": st["proof_sha256"], "coms": st["coms_sha256"],
        "verify": True, "tampered": False,
        "runs": {"sharded": 1, "fused": 0},
        "argument_collectives": {"all_gather": 5, "all_reduce": 5}}


def test_unseeded_ranks_draw_the_same_blindings(worlds):
    """With no seed, the ranks' blindings (and the verifier's batching
    scalar) come from the key shared at mesh activation: all ranks made
    one proof, and it verifies."""
    res = _agreed(worlds[2], "unseeded")
    st = PINS["statements"]["bound16"]
    assert res["verify"] is True and res["proof"] != st["proof_sha256"]


def test_less_than_matches_its_pin(worlds):
    """LESS_THAN (512 gens, a 1026-point table) at D = 2."""
    st = PINS["statements"]["less_than"]
    assert _agreed(worlds[2], "less_than") == {
        "proof": st["proof_sha256"], "coms": st["coms_sha256"],
        "verify": True, "tampered": False,
        "runs": {"sharded": 1, "fused": 0},
        "argument_collectives": {"exchange": 1, "all_gather": 18,
                                 "all_reduce": 18}}


def test_batch_matches_its_pin(worlds):
    """batch_bound16x3_table through lang.batch.prove_batch at D = 2: the
    k = 9 commitment MSM on the sharded table, three sharded arguments."""
    b = PINS["batches"]["batch_bound16x3_table"]
    assert _agreed(worlds[2], "batch") == {"proof": b["proof_sha256"],
                               "coms": b["coms_sha256"]}


def test_table_factory_per_mesh(worlds):
    """One shard: GeneratorTable; two: ShardedGeneratorTable, cached per
    mesh."""
    assert _agreed(worlds[2], "factory") == {
        "classes": ["GeneratorTable"] + ["ShardedGeneratorTable"] * 3,
        "same": [True, False]}


def test_collectives(worlds):
    """all_gather, all_reduce and exchange over three ranks, on each rank
    (the exchange multicasts: positions 0 and 1 read one rank)."""
    x = [torch.arange(6).view(2, 3) + 10 * s for s in range(3)]
    for res in (r["collectives"] for r in worlds[3]):
        assert res["gather"] == torch.stack(x).tolist()
        assert res["sum"] == sum(x).tolist()
        assert res["max"] == x[2].tolist()
    got = [r["collectives"]["exchange"] for r in worlds[3]]
    assert got == [x[src].tolist() for src in worlds[3][0]["collectives"]
                   ["src_of"]]


@pytest.mark.parametrize("n_full", [16, 64])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_exchange_plan_matches_jax(n_full, d):
    """The port's plan against the JAX package's _RoundFns._perm (pure
    Python) for every half >= n_loc."""
    from bulletproof_gadgets_tpu.parallel.sharded_ipa import _RoundFns
    fns = _RoundFns.__new__(_RoundFns)
    fns.n_full, fns.n_loc, fns.D = n_full, n_full // d, d
    half = n_full // 2
    while half >= fns.n_loc:
        assert sharded_ipa.plan(n_full, fns.n_loc, half) == fns._perm(half)
        half //= 2


def test_initialize_without_arguments_or_env_is_a_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        distributed.initialize("localhost:1", 2)


def test_failing_rank_fails_within_its_limit(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: run_ranks kills
    both and raises with rank 1's traceback, long before the process
    group's timeout."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*"
                       "stops before its collective"):
        distributed.run_ranks(_rank_fails, 2, str(tmp_path / "store"),
                              timeout=SPAWN_LIMIT,
                              pg_timeout=datetime.timedelta(seconds=120))
    assert time.time() - t0 < 60
