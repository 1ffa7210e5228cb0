"""The tier-1 scheduler in the repo's root conftest.py: every test it names
exists, and its long units start first, one to a worker."""
import importlib.util
import pathlib
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("tier1_units",
                                               ROOT / "conftest.py")
units = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(units)


def test_named_tests_exist(request):
    """A renamed or removed test must leave SPLIT and LONG with it."""
    ids = [item.nodeid for item in request.session.items]
    files = {i.partition("::")[0] for i in ids}
    for path, names in units.SPLIT.items():
        if path not in files:
            continue
        for name in names:
            full = f"{path}::{name}"
            assert any(i == full or i.startswith(full + "[") for i in ids), \
                full
    found = {units.unit_of(i) for i in ids}
    for unit in units.LONG:
        if unit.partition("::")[0] in files:
            assert unit in found, unit


def test_unit_of():
    fused = "tests/test_ipa_fused.py"
    assert units.unit_of(
        f"{fused}::test_fused_ipa_folded_table_matches_host[64-2]") == \
        f"{fused}::fold64"
    assert units.unit_of(
        f"{fused}::test_fused_ipa_folded_table_matches_host[256-3]") == \
        f"{fused}::fold256"
    assert units.unit_of(f"{fused}::test_fused_ipa_matches_host[False-2]") \
        == fused
    assert units.unit_of("tests/test_msm_serial.py::test_generator_table") \
        == "tests/test_msm_serial.py::chunks"
    assert units.unit_of("tests/test_flvec.py::test_x[1]") == \
        "tests/test_flvec.py"


class _Node:
    def __init__(self, i):
        self.gateway = types.SimpleNamespace(id=f"gw{i}")
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


@pytest.mark.parametrize("workers", [2, 6])
def test_long_units_start_first_one_to_a_worker(workers):
    pytest.importorskip("xdist")
    # Many short files, each with more tests than any long unit, so that
    # loadfile's own order (most tests first) would start them first.
    collection = [f"tests/test_short{f}.py::test_{t}"
                  for f in range(12) for t in range(9)]
    long_tests = {}
    for unit in units.LONG:
        path, _, group = unit.partition("::")
        names = [n for n, g in units.SPLIT.get(path, {}).items()
                 if g == group] if group else ["test_rest"]
        long_tests[unit] = [f"{path}::{n}" for n in names]
        collection += long_tests[unit]
    config = types.SimpleNamespace(
        getvalue=lambda key: [f"{workers}*popen"],
        option=types.SimpleNamespace(loadscopereorder=True))
    sched = units.unit_scheduling()(config, None)
    sched.log = lambda *args: None
    nodes = [_Node(i) for i in range(workers)]
    for node in nodes:
        sched.add_node(node)
    for node in nodes:
        sched.add_node_collection(node, collection)
    sched.schedule()

    def long_units_of(node):
        return [u for u in units.LONG
                if any(collection[i] in long_tests[u] for i in node.sent)]

    held = [long_units_of(node) for node in nodes]
    assert [h[0] for h in held] == list(units.LONG[:workers])
    assert all(len(h) == 1 for h in held)
    # The next long unit waits for a worker that has finished its own.
    node, done = nodes[0], 0
    while done < len(node.sent):
        assert units.LONG[workers] not in long_units_of(node)
        sched.mark_test_complete(node, node.sent[done])
        done += 1
        if units.LONG[workers] in long_units_of(node):
            break
    first = set(long_tests[units.LONG[0]])
    assert first <= {collection[i] for i in node.sent[:done]}
    assert units.LONG[workers] in long_units_of(node)
    assert all(len(long_units_of(n)) == 1 for n in nodes[1:])
