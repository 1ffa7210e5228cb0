"""Importing the harness's entry and the reference loads neither JAX nor
the JAX package; the reference loads nothing of the port either.  Names
are compared whole, by the part before the first dot."""
import json
import os
import subprocess
import sys

from harness import spec

PROBE = """
import json, runpy, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body):
    code = PROBE.format(bench=spec.BENCH, root=spec.ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_harness_load_no_jax():
    loaded = _loaded("runpy.run_path({!r}, run_name='bench_run')\n"
                     "from harness import runner, check, trace, faults\n"
                     "import bulletproof_gadgets_tpu_torch.lang.batch\n"
                     "import bulletproof_gadgets_tpu_torch.lang.verify"
                     .format(os.path.join(spec.BENCH, "run.py")))
    assert not loaded & {"jax", "jaxlib", "flax", "bulletproof_gadgets_tpu"}
    assert "bulletproof_gadgets_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import reference.lang.verify, reference.models.mimc\n"
                     "import reference.core.curve_torch")
    assert not loaded & {"jax", "jaxlib", "flax", "bulletproof_gadgets_tpu",
                         "bulletproof_gadgets_tpu_torch"}


def test_forbidden_names_are_whole():
    from harness import runner
    sys.modules.setdefault("bulletproof_gadgets_tpu_torch_probe", sys)
    assert "bulletproof_gadgets_tpu" not in runner.forbidden_modules()
