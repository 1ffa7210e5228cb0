"""The port's embedding surfaces on the CPU, held against the JAX package's
pins (tests/port_pins.json, frozen by scripts/freeze_port_pins.py): the
HTTP proof service (cli/serve), the C ABI (capi/bpg_ffi.c) loaded into
this process and embedded in a C program, the JNI layer (capi/bpg_jni.c)
through a JNIEnv made in Python, ffi.py's error mapping, and
utils/profiling.

Statements are inline pins: the 16-bit BOUND and the flat and nested OR
conjunctions (the first port test of lang.prove._or_conjunction /
lang.verify._or_conjunction), on the host table.
"""
import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import sysconfig
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from bulletproof_gadgets_tpu_torch import capi, ffi, native
from bulletproof_gadgets_tpu_torch.capi import jni_host
from bulletproof_gadgets_tpu_torch.cli import serve
from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.ops import engine
from bulletproof_gadgets_tpu_torch.utils import profiling, rng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())
BOUND16 = PINS["statements"]["bound16"]


@pytest.fixture
def port_on_cpu():
    engine.register("cpu")
    port_msm.set_table_min_size(1 << 30)          # host tables
    yield
    port_msm.set_table_min_size(None)


@pytest.fixture
def seeded():
    rng.set_seed(PINS["seed"])
    yield
    rng.set_seed(None)


def _sha(data):
    return hashlib.sha256(data).hexdigest()


def _tampered(proof: bytes) -> bytes:
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    return bytes(bad)


@pytest.fixture
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, path, payload):
    """(status, JSON body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("name", ["bound16", "or_flat", "or_nested"])
def test_http_prove_verify(port_on_cpu, server, name):
    st = PINS["statements"][name]
    rng.set_seed(PINS["seed"])
    try:
        code, out = _post(server, "/prove", {
            "name": name, "instance": st["instance"],
            "witness": st["witness"], "gadgets": st["gadgets"]})
    finally:
        rng.set_seed(None)
    assert code == 200, out
    proof = bytes.fromhex(out["proof"])
    assert out["constraints"] == st["constraints"]
    assert _sha(proof) == st["proof_sha256"]
    assert _sha(out["commitments"].encode()) == st["coms_sha256"]
    req = {"name": name, "instance": st["instance"], "proof": out["proof"],
           "commitments": out["commitments"], "gadgets": st["gadgets"]}
    assert _post(server, "/verify", req) == (200, {"verified": True})
    req["proof"] = _tampered(proof).hex()
    assert _post(server, "/verify", req) == (200, {"verified": False})


def test_http_rejects_bad_requests(port_on_cpu, server):
    code, out = _post(server, "/prove", {"name": "bound16",
                                         "instance": BOUND16["instance"]})
    assert code == 400 and "missing field" in out["error"]
    assert _post(server, "/nowhere", {})[0] == 404


def test_serve_needs_its_device_at_start(monkeypatch):
    """CUDA asked for where there is none: main() raises before it
    listens."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    monkeypatch.setenv("BPG_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["0"])


def test_c_abi_hosted(port_on_cpu):
    """c_prove / c_verify loaded into this process (CPython already
    running): the pinned bytes, 1 and 0 for a tampered proof; garbage
    gadgets give 0 and NULL."""
    lib = capi.load_ffi()
    inst, wtns, gad = (BOUND16[k].encode()
                       for k in ("instance", "witness", "gadgets"))
    rng.set_seed(PINS["seed"])
    try:
        art = lib.c_prove(b"bound16", inst, wtns, gad)
    finally:
        rng.set_seed(None)
    assert art, "c_prove returned NULL"
    a = art.contents
    proof, coms = ctypes.string_at(a.proof, a.len), a.commitments
    lib.free_proof(art)
    assert _sha(proof) == BOUND16["proof_sha256"]
    assert _sha(coms) == BOUND16["coms_sha256"]
    assert lib.c_verify(b"bound16", inst, proof, len(proof), coms, gad) == 1
    bad = _tampered(proof)
    assert lib.c_verify(b"bound16", inst, bad, len(bad), coms, gad) == 0
    assert lib.c_verify(b"bound16", inst, proof, len(proof), coms,
                        b"NOT_A_GADGET W0\n") == 0
    assert not lib.c_prove(b"bound16", inst, wtns, b"NOT_A_GADGET W0\n")


def test_jni_prove_verify(port_on_cpu):
    ext_prove, ext_verify = jni_host.entry_points(capi.jni_library())
    wrapper = {"name": "bound16", "instance": BOUND16["instance"],
               "witness": BOUND16["witness"], "gadgets": BOUND16["gadgets"]}
    jni = jni_host.FakeJNI(wrapper)      # its table lives as long as this
    rng.set_seed(PINS["seed"])
    try:
        ext_prove(jni.env, None, 1)
    finally:
        rng.set_seed(None)
    assert _sha(bytes(wrapper["proof"])) == BOUND16["proof_sha256"]
    assert _sha(wrapper["commitments"].encode()) == BOUND16["coms_sha256"]
    assert ext_verify(jni.env, None, 1) == 1
    bad = jni_host.FakeJNI(
        dict(wrapper, proof=bytearray(_tampered(bytes(wrapper["proof"])))))
    assert ext_verify(bad.env, None, 1) == 0


def test_standalone_embedding(tmp_path):
    """bpg_embed, a C program, starts CPython and the port through the C
    ABI in a fresh process: the pinned proof, true, tampered false."""
    for ext, key in ((".inst", "instance"), (".wtns", "witness"),
                     (".gadgets", "gadgets")):
        (tmp_path / f"bound16{ext}").write_text(BOUND16[key])
    env = dict(os.environ, BPG_TPU_SEED=PINS["seed"], BPG_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), sysconfig.get_paths()["purelib"]]))
    out = subprocess.run([capi.embed_program(), str(tmp_path), "bound16"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    proof_hex, verdict, tampered = out.stdout.splitlines()
    assert _sha(bytes.fromhex(proof_hex)) == BOUND16["proof_sha256"]
    assert (verdict, tampered) == ("true", "tampered false")


def test_ffi_verify_maps_bad_input_to_false(port_on_cpu, seeded):
    coms, proof = ffi.ffi_prove("bound16", BOUND16["instance"],
                                BOUND16["witness"], BOUND16["gadgets"])
    args = ("bound16", BOUND16["instance"], proof, coms, BOUND16["gadgets"])
    assert ffi.ffi_verify(*args) is True
    bad_inputs = [
        dict(proof=b"\x00" * 7),                            # ProofError
        dict(proof=_tampered(proof)),                       # rejected
        dict(gadgets="NOT_A_GADGET W0\n"),                  # ValueError
        dict(gadgets="BOUND W0 I0\n"),                      # ParseError
        dict(commitments=""),                               # KeyError
        dict(instance="I0 = 0x0010\n"),                     # KeyError
    ]
    names = ("name", "instance", "proof", "commitments", "gadgets")
    for bad in bad_inputs:
        kw = dict(zip(names, args), **bad)
        assert ffi.ffi_verify(*(kw[n] for n in names)) is False, bad


def test_ffi_verify_propagates_build_failures(port_on_cpu, seeded,
                                               monkeypatch):
    """A kernel library or C transcript that fails to build is an error,
    never a rejected proof."""
    coms, proof = ffi.ffi_prove("bound16", BOUND16["instance"],
                                BOUND16["witness"], BOUND16["gadgets"])
    args = ("bound16", BOUND16["instance"], proof, coms, BOUND16["gadgets"])

    def broken(what):
        def fail(*args):
            raise RuntimeError(f"{what} failed")
        return fail
    with monkeypatch.context() as m:
        # the verifier's table on the device path, its wrappers asking for
        # the kernel library as they would for CUDA tensors
        port_msm.set_table_min_size(8)
        m.setattr(native, "load", broken("nvcc"))
        m.setattr(native, "kernels_for", lambda *t: native.load())
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ffi.ffi_verify(*args)
    port_msm.set_table_min_size(1 << 30)
    with monkeypatch.context() as m:
        m.setattr(capi, "_LIB", None)
        m.setattr(capi, "_compile", broken("cc"))
        with pytest.raises(RuntimeError, match="cc failed"):
            ffi.ffi_verify(*args)


def test_profiling(tmp_path):
    with profiling.phase_timings() as timings:
        with profiling.phase("a"):
            torch.ones(64).sum()
        with profiling.phase("a"):
            pass
        with profiling.phase("b"):
            pass
    assert set(timings) == {"a", "b"} and timings["a"] > 0
    with profiling.phase("outside"):                # no collector: no-op
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.arange(1000).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
