"""Tier-1 scheduling under ``pytest -n N --dist loadfile``.

loadfile runs each test file whole on one worker, so the run lasts at
least as long as its longest file. Two files of the JAX package's tests
each take a large share of the run: their tests spend minutes compiling
the package's kernels on the CPU. The scheduler below keeps loadfile's
grouping, but runs named groups of those files' tests as units of their
own, and starts the long units first, each on a worker that holds no
other long unit. Which tests run, and what they check, do not change.

The rule: no unit should sum to more than about 650 s in the tier-1
junit. A new test that takes minutes goes into a file of its own and into
``LONG``; tests that compile the same shapes stay in one unit, so that
one process compiles them once.
"""
import pytest

# Tests of a long file that run apart from the rest of it, as
# {file: {test name or parametrised id: unit}}. The batched transcript-meta
# test stays with test_fused_ipa_matches_host, whose n = 8 compiles it
# reuses (~200 s there, ~340 s apart).
SPLIT = {
    "tests/test_ipa_fused.py": {
        "test_fused_ipa_folded_table_matches_host[64-2]": "fold64",
        "test_fused_ipa_folded_table_matches_host[256-3]": "fold256",
        "test_fused_ipa_chunked_table": "batched",
        "test_fused_ipa_batched_matches_host": "batched",
    },
    "tests/test_msm_serial.py": {
        "test_generator_table": "chunks",
        "test_chunked_bucket_accumulation": "chunks",
        "test_static_c13_matches_host": "chunks",
        "test_point_chunked_launch_matches_host": "chunks",
    },
}

# Units of a few minutes each, longest first.
LONG = (
    "tests/test_ipa_fused.py",
    "tests/test_ipa_fused.py::fold256",
    "tests/test_ipa_fused.py::fold64",
    "tests/test_msm_serial.py",
    "tests/test_ipa_device.py",
    "tests/test_msm_serial.py::chunks",
    "tests/test_ipa_fused.py::batched",
    "tests/test_batch.py",
)


def unit_of(nodeid):
    """The unit a test runs in: its file, or a named group of its file."""
    path, _, name = nodeid.partition("::")
    group = SPLIT.get(path, {})
    unit = group.get(name) or group.get(name.split("[")[0])
    return f"{path}::{unit}" if unit else path


def unit_scheduling():
    """loadfile's scheduler over units (xdist is imported here, since a
    run without it loads this file too)."""
    from xdist.scheduler import LoadFileScheduling

    class UnitScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit_of(nodeid)

        def _assign_work_unit(self, node):
            held = {scope for scope, tests in
                    self.assigned_work.get(node, {}).items()
                    if not all(tests.values())}
            if held.isdisjoint(LONG):
                pick = (s for s in LONG if s in self.workqueue)
            else:
                pick = (s for s in self.workqueue if s not in LONG)
            scope = next(pick, None)
            if scope is not None:
                self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return UnitScheduling


@pytest.hookimpl(optionalhook=True, tryfirst=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    return unit_scheduling()(config, log)
