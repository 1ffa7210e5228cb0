"""Tampered proofs and the constraint-template cache through the port's
lang.prove / lang.verify: the cases of the JAX package's
tests/test_statements.py (a flipped proof byte, another statement name,
swapped commitment lines) and tests/test_template_cache.py (a cache hit
reproduces the bytes; new witnesses on the hit path verify; an
out-of-range witness on it fails; a value collision at template-build
time does not cross-bind), with inline statements.

Each runs on the host generator table here (the statements are below the
device tables' size rule) and, cuda-marked, with the generator table
forced onto the device path (`core.msm.set_table_min_size(8)`) on the
card.
"""
import pytest
import torch

from bulletproof_gadgets_tpu_torch.core import msm as core_msm
from bulletproof_gadgets_tpu_torch.lang import template
from bulletproof_gadgets_tpu_torch.lang.prove import prove
from bulletproof_gadgets_tpu_torch.lang.verify import verify
from bulletproof_gadgets_tpu_torch.ops import engine
from bulletproof_gadgets_tpu_torch.utils import rng

torch.set_num_threads(1)

EQ = ("EQUALS W0 W1\n", "", "W0 = 0x0539\nW1 = 0x0539\n")
NE = ("UNEQUAL W0 W1\n", "", "W0 = 0x07\nW1 = 0x2a09\n")
OR = ("OR [\n{\nEQUALS W0 I0\n}\n{\nUNEQUAL W1 I1\n}\n]\n",
      "I0 = 0x08\nI1 = 0x0539\n", "W0 = 0x07\nW1 = 0x09\n")


@pytest.fixture(params=["host", pytest.param("device",
                                             marks=pytest.mark.cuda)])
def device(request):
    """The device the statements run on, with empty template caches; the
    device variant forces the generator table onto the device path."""
    template.prover_cache.d.clear()
    template.verifier_cache.d.clear()
    if request.param == "device":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                        "mode)")
        core_msm.set_table_min_size(8)
        dev = "cuda"
    else:
        dev = "cpu"
    yield dev
    core_msm.set_table_min_size(None)
    rng.set_seed(None)
    engine.register("cpu")


def _prove(name, stmt, device, seed, witness=None):
    gadgets, instance, wit = stmt
    rng.set_seed(seed)
    coms = []
    proof, n = prove(name, instance, witness or wit, gadgets, coms,
                     device=device)
    return proof, n, coms


def _verify(name, stmt, proof, coms, device):
    gadgets, instance, _ = stmt
    return verify(name, instance, proof, "".join(coms), gadgets,
                  device=device)


def test_flipped_byte_and_other_name_rejected(device):
    proof, _, coms = _prove("equality", EQ, device, "tamper-eq")
    assert _verify("equality", EQ, proof, coms, device)
    bad = bytearray(proof)
    bad[64] ^= 1
    assert not _verify("equality", EQ, bytes(bad), coms, device)
    assert not _verify("other", EQ, proof, coms, device)


def test_swapped_commitment_lines_rejected(device):
    proof, _, coms = _prove("inequality", NE, device, "tamper-ne")
    assert len(coms) >= 2 and _verify("inequality", NE, proof, coms, device)
    swapped = [coms[1], coms[0]] + coms[2:]
    assert not _verify("inequality", NE, proof, swapped, device)


@pytest.mark.parametrize("stmt", [NE, OR], ids=["inequality", "or"])
def test_hit_reproduces_bytes(device, stmt):
    first = _prove("tmpl", stmt, device, "tmpl")          # miss (builds)
    again = _prove("tmpl", stmt, device, "tmpl")          # hit
    assert first == again
    assert _verify("tmpl", stmt, again[0], again[2], device)


def test_hit_with_new_witness_bits_and_out_of_range(device):
    """An 8-bit BOUND: a new value on the hit path re-derives its bits and
    verifies; a value past the bound proves but does not verify."""
    stmt = ("BOUND W0 I0 I1\n", "I0 = 0x0a\nI1 = 0x64\n", "W0 = 0x43\n")
    for seed, wit, ok in (("tmpl-b1", None, True),
                          ("tmpl-b2", "W0 = 0x17\n", True),
                          ("tmpl-b3", "W0 = 0x65\n", False)):
        proof, _, coms = _prove("b", stmt, device, seed, wit)
        assert _verify("b", stmt, proof, coms, device) is ok


def test_hit_with_new_witness_inequality(device):
    proof, _, coms = _prove("inequality", NE, device, "tmpl-i1")
    assert _verify("inequality", NE, proof, coms, device)
    proof, _, coms = _prove("inequality", NE, device, "tmpl-i2",
                            "W0 = 0x5d\nW1 = 0x2a53\n")   # low bytes ^ 0x5a
    assert _verify("inequality", NE, proof, coms, device)


def test_build_time_value_collision_binds_by_identity(device):
    """A template built where W0 == W1 must not cross-bind their bit
    recipes: a hit with W0 != W1 verifies, and an out-of-range W1 on the
    hit path fails."""
    stmt = ("BOUND W0 I0 I1\nBOUND W1 I0 I1\n", "I0 = 0x0a\nI1 = 0x64\n",
            "W0 = 0x43\nW1 = 0x43\n")
    for seed, wit, ok in (("tmpl-c1", None, True),
                          ("tmpl-c2", "W0 = 0x17\nW1 = 0x60\n", True),
                          ("tmpl-c3", "W0 = 0x17\nW1 = 0x65\n", False)):
        proof, _, coms = _prove("c", stmt, device, seed, wit)
        assert _verify("c", stmt, proof, coms, device) is ok
