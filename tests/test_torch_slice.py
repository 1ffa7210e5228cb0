"""The port's main path on the CPU against the JAX package: statements
proved under the same blinding seed must give byte-identical `.proof` and
`.coms`, each package must accept the other's proof, and the port must
never import JAX.

The port is registered on the CPU (its kernel wrappers run their plain
versions) and, for the 16-bit BOUND, forced onto its device-table path with
`core.msm.set_table_min_size(8)`; the JAX package proves the same statement
on its host path (a 66-point table is under its device threshold).  On the
device table the port's inner-product argument runs ops/ipa_fused.
"""
import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from bulletproof_gadgets_tpu.lang.prove import prove as jax_prove
from bulletproof_gadgets_tpu.lang.verify import verify as jax_verify
from bulletproof_gadgets_tpu.utils import rng as jax_rng
from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.lang.prove import prove
from bulletproof_gadgets_tpu_torch.lang.verify import verify
from bulletproof_gadgets_tpu_torch.ops import (engine, flatten, ipa_fused,
                                               msm_serial)
from bulletproof_gadgets_tpu_torch.utils import rng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())
PORT = ROOT / "bulletproof_gadgets_tpu_torch"


@pytest.fixture
def port_on_cpu():
    engine.register("cpu")
    port_msm.set_table_min_size(8)
    yield
    port_msm.set_table_min_size(None)


@pytest.fixture
def ipa_calls(monkeypatch):
    """Records every ops/ipa_fused.create call (its n)."""
    calls = []
    real = ipa_fused.create

    def spy(transcript, table, w, G_factors, *args, **kw):
        calls.append(len(G_factors))
        return real(transcript, table, w, G_factors, *args, **kw)
    monkeypatch.setattr(ipa_fused, "create", spy)
    return calls


def _prove(prove_fn, seed_mod, name):
    st = PINS["statements"][name]
    seed_mod.set_seed(PINS["seed"])
    coms = []
    try:
        proof, _ = prove_fn(name, st["instance"], st["witness"],
                            st["gadgets"], coms)
    finally:
        seed_mod.set_seed(None)
    return proof, "".join(coms)


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def test_bound16_matches_jax_byte_for_byte(port_on_cpu, ipa_calls):
    st = PINS["statements"]["bound16"]
    before = dict(msm_serial.LAUNCHES)
    port_proof, port_coms = _prove(prove, rng, "bound16")
    assert ipa_calls == [st["gens"]]          # the device IPA ran
    jax_proof, jax_coms = _prove(jax_prove, jax_rng, "bound16")
    assert port_proof == jax_proof
    assert port_coms == jax_coms
    assert _sha(port_proof) == st["proof_sha256"]
    assert _sha(port_coms.encode()) == st["coms_sha256"]
    # no CUDA here, so no kernel launch was counted
    assert msm_serial.LAUNCHES == before
    args = ("bound16", st["instance"])
    assert verify(*args, jax_proof, jax_coms, st["gadgets"])
    assert jax_verify(*args, port_proof, port_coms, st["gadgets"])
    bad = bytearray(port_proof)
    bad[100] ^= 1
    assert not verify(*args, bytes(bad), port_coms, st["gadgets"])


def test_less_than_matches_its_pin(port_on_cpu, ipa_calls, monkeypatch):
    """LESS_THAN on the device path with every vector on the device
    (flattening forced below its size rule) and the 1026-point table in
    point chunks of 1024 (two chunks: every table MSM adds its chunks'
    window sums with K7's plain version): proof and .coms equal the pin."""
    st = PINS["statements"]["less_than"]
    monkeypatch.setattr(flatten, "MIN_DEVICE_TERMS", 0)
    monkeypatch.setattr(msm_serial, "POINT_CHUNK", 1024)
    flats, adds = [], []
    real_flatten, real_add = flatten.flatten, msm_serial.point_sum
    monkeypatch.setattr(flatten, "flatten", lambda *a, **kw: flats.append(
        real_flatten(*a, **kw)) or flats[-1])
    monkeypatch.setattr(msm_serial, "point_sum",
                        lambda ws: adds.append(ws.shape[3]) or real_add(ws))
    proof, coms = _prove(prove, rng, "less_than")
    assert ipa_calls == [st["gens"]]
    assert len(flats) == 1 and flats[0] is not None
    # one combine per table MSM: the commitments (k = 3), 9 IPA rounds (k = 2)
    assert adds == [3 * msm_serial.W] + [2 * msm_serial.W] * 9
    assert _sha(proof) == st["proof_sha256"]
    assert _sha(coms.encode()) == st["coms_sha256"]
    assert verify("less_than", st["instance"], proof, coms, st["gadgets"])
    assert len(flats) == 2 and flats[1].wc is not None
    assert adds[-1] == msm_serial.W                # the verifier's table MSM


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device given and none registered, prove and verify ask for
    CUDA: where it is missing they raise and never run on the CPU;
    device="cpu" runs the plain versions."""
    st = PINS["statements"]["bound16"]
    args = ("bound16", st["instance"])
    monkeypatch.setattr(engine, "_device", None)
    if torch.cuda.is_available():
        _prove(prove, rng, "bound16")
        assert engine._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove(*args, st["witness"], st["gadgets"], [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify(*args, b"", "", st["gadgets"])
    assert engine._device is None
    rng.set_seed(PINS["seed"])
    coms = []
    try:
        proof, _ = prove(*args, st["witness"], st["gadgets"], coms,
                         device="cpu")
    finally:
        rng.set_seed(None)
    assert _sha(proof) == st["proof_sha256"]
    assert verify(*args, proof, "".join(coms), st["gadgets"])


def test_cli_round_trip_and_device_choice(tmp_path):
    st = PINS["statements"]["bound16"]
    for ext, key in ((".inst", "instance"), (".wtns", "witness"),
                     (".gadgets", "gadgets")):
        (tmp_path / f"bound16{ext}").write_text(st[key])
    env = dict(os.environ, BPG_TORCH_DEVICE="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    run = lambda mod, **kw: subprocess.run(                   # noqa: E731
        [sys.executable, "-m", f"bulletproof_gadgets_tpu_torch.cli.{mod}",
         "bound16"], cwd=tmp_path, capture_output=True, text=True, **kw)
    out = run("prover", env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(st["constraints"])
    out = run("verifier", env=env)
    assert out.returncode == 0 and out.stdout.strip() == "true", out.stderr
    # CUDA asked for where there is none: the CLI raises, never falls back
    out = run("verifier", env=dict(env, BPG_TORCH_DEVICE="cuda"))
    assert out.returncode != 0 and "CUDA is not available" in out.stderr


def test_port_never_imports_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bulletproof_gadgets_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "jaxlib")), \
                (path, line)
    # C reaches Python modules by name (PyImport_ImportModule): no string in
    # the port's C sources may name the JAX package
    c_files = sorted(PORT.rglob("*.[ch]"))
    assert c_files
    for path in c_files:
        for line in path.read_text().splitlines():
            assert not re.search(r"bulletproof_gadgets_tpu(?!_torch)", line), \
                (path, line)
