"""Batched proving in the port on the CPU (lang/batch: the lockstep loop
of Prover.prove_gen, ops/ipa_fused.create_batched, the round-chunked MSM
with K2's plain version, the device MiMC sponge), where every kernel
wrapper runs its plain PyTorch version.

A batch's bytes are not those of sequential proves: every witness is
prepared before any proof starts, and on a device table the lockstep draws
every proof's commitment blindings before any proof's t-poly blindings.
So the oracle is the JAX package's own prove_batch on the same kind of
table under the same seed, frozen into tests/port_pins.json ("batches",
scripts/freeze_port_pins.py --batch): no JAX Pallas code runs here.
"""
import hashlib
import json
import pathlib

import pytest
import torch

from bulletproof_gadgets_tpu.models.mimc import mimc_hash as jax_mimc_hash
from bulletproof_gadgets_tpu_torch.core import msm as port_msm
from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch, verify_batch
from bulletproof_gadgets_tpu_torch.models import mimc
from bulletproof_gadgets_tpu_torch.ops import (engine, ipa_fused,
                                               mimc_kernels, msm_serial)
from bulletproof_gadgets_tpu_torch.utils import rng
from bulletproof_gadgets_tpu_torch.utils.conversions import scalar_to_be

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())


@pytest.fixture
def port_on_cpu():
    engine.register("cpu")
    yield
    port_msm.set_table_min_size(None)


@pytest.fixture
def spies(monkeypatch):
    """Records the stacked k of every device-digit MSM, the group size of
    every create_batched call and the rounds of every K2 plain run."""
    seen = {"k": [], "groups": [], "cont": []}
    msm, batched = msm_serial.msm_digits_t, ipa_fused.create_batched
    cont = msm_serial.bucket_accumulate_cont_plain

    def spy_msm(digits, *a, **kw):
        seen["k"].append(digits.shape[0] // msm_serial.W)
        return msm(digits, *a, **kw)

    def spy_batched(transcripts, *a):
        seen["groups"].append(len(transcripts))
        return batched(transcripts, *a)

    def spy_cont(src, idx, acc):
        seen["cont"].append(idx.shape[0])
        return cont(src, idx, acc)
    monkeypatch.setattr(msm_serial, "msm_digits_t", spy_msm)
    monkeypatch.setattr(ipa_fused, "create_batched", spy_batched)
    monkeypatch.setattr(msm_serial, "bucket_accumulate_cont_plain", spy_cont)
    return seen


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def _prove_pin(pin, **kw):
    b = PINS["batches"][pin]
    port_msm.set_table_min_size(b["table_min_size"])
    rng.set_seed(PINS["seed"])
    try:
        results = prove_batch(b["name"], b["instance"], b["witnesses"],
                              b["gadgets"], **kw)
    finally:
        rng.set_seed(None)
    assert [_sha(p) for p, _, _ in results] == b["proof_sha256"]
    assert [_sha(c.encode()) for _, _, c in results] == b["coms_sha256"]
    return b, results


def test_host_table_batch_matches_its_pin(port_on_cpu, spies):
    """On a host table prove_gen yields nothing: each proof runs to its end
    in turn after every witness is prepared (no device MSM, no grouped
    argument)."""
    _prove_pin("batch_bound16x3_host")
    assert spies == {"k": [], "groups": [], "cont": []}


@pytest.mark.parametrize("variant", ["stacked", "round_chunks", "max_k3"])
def test_device_table_batch_matches_its_pin(port_on_cpu, spies, variant,
                                            monkeypatch):
    """The three proofs on the device-table path (a 66-point table): their
    commitments in one k = 9 launch (or, with max_k=3, one launch per
    proof), their 5 IPA rounds as k = 6 launches of one create_batched,
    equal to the JAX package's prove_batch.  With the slot budget at 1
    every MSM runs its rounds one per chunk: K1, then K2's plain version
    carrying the pool."""
    if variant == "round_chunks":
        monkeypatch.setattr(msm_serial, "SLOT_BUDGET", 1)
    b, results = _prove_pin("batch_bound16x3_table",
                            **({"max_k": 3} if variant == "max_k3" else {}))
    commits = [3, 3, 3] if variant == "max_k3" else [9]
    assert spies["k"] == commits + [6] * 5
    assert spies["groups"] == [3]
    if variant == "round_chunks":
        assert len(spies["cont"]) >= 2 and set(spies["cont"]) == {1}
    else:
        assert spies["cont"] == []
    if variant == "stacked":
        args = (b["name"], b["instance"])
        proofs = [(p, c) for p, _, c in results]
        bad = bytearray(proofs[1][0])
        bad[100] ^= 1
        proofs.append((bytes(bad), proofs[1][1]))
        assert verify_batch(*args, proofs, b["gadgets"]) == [True] * 3 + [
            False]


def test_mixed_shape_batch_verifies(port_on_cpu, spies):
    """3- and 4-limb EQUALS witnesses (as in the JAX package's mixed-shape
    batch test) beside one 16-bit BOUND, so the circuits pad to the same
    32-gens device table (EQUALS alone has no multiplier) but differ in
    commitment count, hence in transcript length: one grouped argument
    serves both, and both proofs verify."""
    port_msm.set_table_min_size(8)
    gadgets = "EQUALS W0 W1\nBOUND W2 I0 I1\n"
    instance = "I0 = 0x0010\nI1 = 0x1000\n"
    witnesses = [f"W0 = 0x{w}\nW1 = 0x{w}\nW2 = 0x0539\n"
                 for w in ("07" * 65, "07" * 97)]
    results = prove_batch("batch_mix", instance, witnesses, gadgets)
    assert spies["k"] == [6] + [4] * 5
    assert spies["groups"] == [2]
    assert verify_batch("batch_mix", instance,
                        [(p, c) for p, _, c in results],
                        gadgets) == [True, True]


def test_hash_batch_uses_device_images(port_on_cpu, monkeypatch):
    """A HASH batch (972 multipliers, a 2050-point device table): its
    preimages (one sponge block each) and images (two blocks each) are
    hashed by the device sponge first, one call per block count, each
    image equal to the JAX package's host mimc_hash, and both proofs
    verify."""
    gadgets = "HASH W1 W0\n"
    seeds = (b"preimage-one!", b"\x05\x39")
    images = [scalar_to_be(jax_mimc_hash(s)) for s in seeds]
    witnesses = [f"W0 = 0x{s.hex()}\nW1 = 0x{i.hex()}\n"
                 for s, i in zip(seeds, images)]
    sponges = []
    real = mimc_kernels.mimc_sponge_device
    monkeypatch.setattr(mimc_kernels, "mimc_sponge_device", lambda blocks: (
        sponges.append(tuple(blocks.shape[:2])) or real(blocks)))
    mimc._image_cache.clear()
    try:
        results = prove_batch("batch_hash", "", witnesses, gadgets)
        cached = dict(mimc._image_cache)
    finally:
        mimc._image_cache.clear()
    assert sorted(sponges) == [(2, 1), (2, 2)]
    assert set(cached) == set(seeds) | set(images)
    for data, image in cached.items():
        assert image.v == jax_mimc_hash(data).v
    assert verify_batch("batch_hash", "", [(p, c) for p, _, c in results],
                        gadgets) == [True, True]


def test_prove_batch_defaults_to_cuda(monkeypatch):
    """With no device given and none registered, prove_batch asks for CUDA
    and raises where it is missing: no quiet run on the CPU."""
    b = PINS["batches"]["batch_bound16x3_host"]
    monkeypatch.setattr(engine, "_device", None)
    if torch.cuda.is_available():
        prove_batch(b["name"], b["instance"], b["witnesses"][:1],
                    b["gadgets"])
        assert engine._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prove_batch(b["name"], b["instance"], b["witnesses"], b["gadgets"])
    assert engine._device is None
