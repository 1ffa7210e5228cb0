"""utils/profiling, the port's span and counter recorder, on the CPU: the
spans of a lang.batch.prove_batch (nesting, parents, one request id, the
r1cs.* stretches of the lockstep's generators free of the time they lie
suspended) and of a single lang.prove.prove (the same labels), the off
state and the proof bytes with the recorder on and off, readback(), the
collector's hook, spans of two threads at once, and the span names
against the benchmark harness's own (the clock against torch.profiler's:
test_torch_surfaces.py::test_profiling, through trace()'s export)."""
import gc
import hashlib
import importlib.util
import json
import pathlib
import re
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
from bulletproof_gadgets_tpu_torch.lang.prove import prove
from bulletproof_gadgets_tpu_torch.ops import engine
from bulletproof_gadgets_tpu_torch.utils import profiling, rng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "bulletproof_gadgets_tpu_torch"
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())

# the smallest statement on the device-table path: 4 multipliers, a
# 10-point table, 2 argument rounds
UNEQUAL = ("UNEQUAL W0 I0\n", "I0 = 0x07\n", ["W0 = 0x08\n", "W0 = 0x2a\n"])


@pytest.fixture
def recorder():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _prove(seed):
    gadgets, instance, witnesses = UNEQUAL
    rng.set_seed(seed)
    try:
        return prove_batch("unequal", instance, witnesses, gadgets)
    finally:
        rng.set_seed(None)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _overlap(a, b):
    return a[1] < b[2] and b[1] < a[2]


def test_prove_batch_spans(recorder):
    """One request, every span inside its parent and under the request's
    id, and each proof's r1cs.* stretches disjoint from the lockstep's
    answers, the argument and the other proof's stretches."""
    engine.register("cpu")
    port_msm.set_table_min_size(4)                 # a device table
    recorder.enable()
    try:
        _prove("profiling")
    finally:
        recorder.disable()
        port_msm.set_table_min_size(None)

    snap = recorder.snapshot()
    spans = [s for s in snap["spans"] if s[0] != "gc"]
    roots = [s for s in spans if s[3] is None]
    assert [s[0] for s in roots] == ["request"]
    request = roots[0]
    for name, t0, t1, parent, req in snap["spans"]:
        assert t1 is not None and t0 <= t1
        if parent is not None:
            assert req == request[4]
            assert _inside((name, t0, t1), snap["spans"][parent])

    def named(name):
        return [s for s in spans if s[0] == name]

    def children(span):
        i = snap["spans"].index(span)
        return [s[0] for s in spans if s[3] == i]

    assert children(request) == ["batch.prepare", "batch.prepare",
                                 "batch.lockstep", "batch.serialize"]
    for prep in named("batch.prepare"):
        assert [c for c in children(prep) if c != "curve.commit"] == [
            "prepare.witness", "prepare.assemble", "prepare.gens"]
    lockstep = named("batch.lockstep")[0]
    assert sorted(set(children(lockstep))) == [
        "ipa.create_batched", "lockstep.fetch", "lockstep.msm_finish",
        "lockstep.msm_launch", "r1cs.commit", "r1cs.finish", "r1cs.poly",
        "r1cs.t_commit"]

    stretches = [s for s in spans if s[0].startswith("r1cs.")
                 and s[0] != "r1cs.flatten"]
    assert sorted(s[0] for s in stretches) == sorted(
        ["r1cs.commit", "r1cs.poly", "r1cs.t_commit", "r1cs.finish"] * 2)
    answers = [s for s in spans if s[0].startswith("lockstep.")
               or s[0] == "ipa.create_batched"]
    for i, s in enumerate(stretches):
        assert not any(_overlap(s, a) for a in answers)
        assert not any(_overlap(s, o) for o in stretches[i + 1:])
    assert [len(named(n)) for n in ("r1cs.flatten", "ipa.create_batched",
                                    "ipa.create")] == [2, 1, 0]

    counters = snap["counters"]
    assert counters["ipa.batched_proofs"] == 2
    assert "ipa.serial_proofs" not in counters
    assert "readbacks" not in counters           # the CPU reads no device
    assert set(snap["launches"]) >= {"bucket_accumulate", "ladder_fold"}


def test_prove_spans(recorder):
    """A single lang.prove.prove: one request, and its answers under the
    labels the lockstep gives them, disjoint from the r1cs.* stretches."""
    gadgets, instance, witnesses = UNEQUAL
    engine.register("cpu")
    port_msm.set_table_min_size(4)
    recorder.enable()
    rng.set_seed("profiling")
    try:
        prove("unequal", instance, witnesses[0], gadgets, [])
    finally:
        rng.set_seed(None)
        recorder.disable()
        port_msm.set_table_min_size(None)

    snap = recorder.snapshot()
    spans = [s for s in snap["spans"] if s[0] != "gc"]
    roots = [s for s in spans if s[3] is None]
    assert [s[0] for s in roots] == ["request"]
    top = snap["spans"].index(roots[0])
    assert sorted({s[0] for s in spans if s[3] == top}) == [
        "ipa.create_batched", "lockstep.fetch", "lockstep.msm_finish",
        "lockstep.msm_launch", "prepare.assemble", "prepare.gens",
        "prepare.witness", "r1cs.commit", "r1cs.finish", "r1cs.poly",
        "r1cs.t_commit"]
    assert [s[0] for s in spans if s[3] is not None
            and snap["spans"][s[3]][0] == "ipa.create_batched"] == [
        "ipa.create"]
    stretches = [s for s in spans if s[0].startswith("r1cs.")
                 and s[0] != "r1cs.flatten"]
    answers = [s for s in spans if s[0].startswith("lockstep.")
               or s[0] == "ipa.create_batched"]
    assert not any(_overlap(s, a) for s in stretches for a in answers)
    assert snap["counters"]["ipa.serial_proofs"] == 1


def test_off_records_nothing_and_bytes_stay(recorder):
    """The pinned host-table batch, recorder off and on: off records no
    span and no counter; both give the pinned bytes."""
    engine.register("cpu")
    pin = PINS["batches"]["batch_bound16x3_host"]
    port_msm.set_table_min_size(pin["table_min_size"])
    out = []
    try:
        for on in (False, True):
            if on:
                recorder.enable()
            rng.set_seed(PINS["seed"])
            try:
                out.append(prove_batch(pin["name"], pin["instance"],
                                       pin["witnesses"], pin["gadgets"]))
            finally:
                rng.set_seed(None)
                recorder.disable()
            if not on:
                assert recorder.snapshot()["spans"] == []
                assert recorder.snapshot()["counters"] == {}
    finally:
        port_msm.set_table_min_size(None)
    for results in out:
        assert [hashlib.sha256(p).hexdigest() for p, _, _ in results] == \
            pin["proof_sha256"]
    assert out[0] == out[1]
    assert [s[0] for s in recorder.snapshot()["spans"]
            if s[3] is None and s[0] != "gc"] == ["request"]


def test_off_is_one_shared_no_op(recorder):
    assert recorder.span("a") is recorder.span("b")
    assert recorder.begin("a") is None
    recorder.end(None)
    recorder.count("a")
    t = torch.arange(4)
    assert recorder.readback(t) is t
    assert recorder.snapshot()["spans"] == []
    assert recorder.snapshot()["counters"] == {}


class _OnDevice:
    """What readback() reads of a tensor on a device."""
    device = SimpleNamespace(type="cuda")

    def __init__(self, t):
        self.t = t

    def cpu(self):
        return self.t


def test_readback_counts_device_tensors(recorder):
    recorder.enable()
    with recorder.span("outer"):
        host = torch.arange(6, dtype=torch.int64)
        assert recorder.readback(_OnDevice(host)) is host
        assert recorder.readback(host) is host     # on the CPU: no transfer
    snap = recorder.snapshot()
    spans = [s for s in snap["spans"] if s[0] != "gc"]
    assert [s[0] for s in spans] == ["outer", "readback"]
    assert snap["spans"][spans[1][3]] == spans[0]
    assert {k: v for k, v in snap["counters"].items()
            if not k.startswith("gc.")} == {"readbacks": 1}


def test_gc_hook(recorder):
    recorder.enable()
    with recorder.span("outer"):
        gc.collect()
    snap = recorder.snapshot()
    collections = [s for s in snap["spans"] if s[0] == "gc"]
    assert collections and snap["spans"][collections[-1][3]][0] == "outer"
    assert snap["counters"]["gc.gen2"] >= 1
    recorder.disable()
    assert recorder._on_gc not in gc.callbacks
    gc.collect()
    assert recorder.snapshot() == snap


def test_spans_nest_per_thread(recorder):
    """Two threads open spans at once while one runs the collector: every
    span closes, under its own name, inside its own thread's parent."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(200):
            with recorder.span(f"thread{k}.outer"):
                with recorder.span(f"thread{k}.inner"):
                    if k == 0 and i % 50 == 0:
                        gc.collect()

    recorder.enable()
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        recorder.disable()
        sys.setswitchinterval(switch)
    spans = recorder.snapshot()["spans"]
    assert all(s[2] is not None for s in spans)
    for k in (0, 1):
        outer = [s for s in spans if s[0] == f"thread{k}.outer"]
        inner = [s for s in spans if s[0] == f"thread{k}.inner"]
        assert len(outer) == len(inner) == 200
        assert all(s[3] is None for s in outer)
        for s in inner:
            assert spans[s[3]][0] == f"thread{k}.outer"
            assert _inside(s, spans[s[3]])
    collections = [s for s in spans if s[0] == "gc"]
    assert len(collections) >= 4
    assert all(s[3] is None or _inside(s, spans[s[3]]) for s in collections)


def _harness_span_names():
    spec = importlib.util.spec_from_file_location(
        "harness_trace", ROOT / "benchmark" / "harness" / "trace.py")
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    return set(trace.SPANS) | {"verify"}


def test_span_names_are_the_programs_own():
    """Every span name in the package is dotted by layer (but request,
    readback and gc) and none is a name the benchmark harness records."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r"\b(?:span|begin)\(\s*\"([^\"]+)\"", text))
        names |= set(re.findall(r"yield_from\([^\"]*\"([^\"]+)\"\)", text,
                                re.S))
    assert {"request", "readback", "gc", "batch.prepare", "r1cs.finish",
            "native.build", "gens.map"} <= names
    for name in names - {"request", "readback", "gc"}:
        assert re.fullmatch(r"[a-z0-9_]+\.[a-z0-9_.]+", name), name
    assert not names & _harness_span_names()
