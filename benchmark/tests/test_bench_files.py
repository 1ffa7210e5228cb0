"""Every file BENCHMARK.json names is there and loads, and every name and
unit keeps to the allowed characters."""
import json
import os

import pytest

from harness import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for group in ("configs", "workloads", "end_to_end",
                                     "per_layer") for e in BENCH[group]]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert spec.reports(moved, cell), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = spec.load(cell)
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert callable(c.statement.draw)
    assert c.traffic["kind"] in ("prove_batch", "verify")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.readers) == {m["name"] for m in c.per_layer}


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    path = os.path.join(spec.ROOT, config["file"])
    with open(path) as f:
        body = json.load(f)
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
    for key in config["reduced"]:
        assert spec.NAME.match(key)
