"""Everything a cell is made of, found by name: its entry in BENCHMARK.json,
configs/<config>.json, statements/<config>.py, traffic/<traffic>.json and
metrics/<metric>.py."""
import importlib.util
import json
import os
import re
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    statement: object               # module with draw(rng, cfg, batch)
    traffic: dict
    end_to_end: list                # the BENCHMARK.json entries it reports
    per_layer: list
    readers: dict = field(default_factory=dict)   # metric name -> read()


def reports(metric, cell_name):
    """Whether a metric entry is reported by the cell (its `workloads` key,
    or every cell where it has none)."""
    return cell_name in metric.get("workloads", [cell_name])


def load(cell_name, bench_path=None):
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[cell_name]
    with open(os.path.join(BENCH, "configs", w["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    statement = load_module(
        os.path.join(BENCH, "statements", w["config"] + ".py"),
        "statement_" + w["config"].replace(".", "_"))
    e2e = [m for m in bench["end_to_end"] if reports(m, cell_name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, cell_name)]
    readers = {m["name"]: load_module(
        os.path.join(BENCH, "metrics", m["name"] + ".py"),
        "metric_" + m["name"].replace(".", "_")).read for m in per_layer}
    return Cell(cell_name, w["chips"], config, statement, traffic, e2e,
                per_layer, readers)
