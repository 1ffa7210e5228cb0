"""A run of the harness with the timed path broken underneath comes out not
correct, for each fault a cell can have and for the controls; a sound run
comes out correct.  The look for a card is skipped: the port runs its
plain versions on the CPU, on statements small enough for it."""
import time

import pytest
import torch

import bench_tiny
from harness import runner

CPU = torch.device("cpu")


def _run(kind, statement, fault, seed=2**31 + 7, requests=2):
    from bulletproof_gadgets_tpu_torch.models import mimc
    mimc._image_cache.clear()
    cell = bench_tiny.cell(kind, statement)
    return runner.run(cell, seed, 0, False, time.perf_counter(),
                      device=CPU, fault=fault, requests=requests)


@pytest.mark.parametrize("kind", ["prove_batch", "verify"])
def test_sound_run_is_correct(kind):
    r = _run(kind, "bound16", None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 2
    assert all(v["limit"] == 0 for v in r["checks"].values())


@pytest.mark.parametrize("fault,number", [
    ("tamper", "proofs_rejected"),      # an answer altered where made
    ("tamper_slot", "proofs_rejected"),     # ... in one slot of the batch
    ("repeat", "proofs_repeated"),      # a step returning its old state
    ("half", "requests_failed"),        # half of the batch left out
])
def test_fault_is_caught(fault, number):
    r = _run("prove_batch", "bound16", fault)
    assert not r["correct"]
    assert r["checks"][number]["value"] > 0


@pytest.mark.parametrize("batch,n", [(4, 8), (8, 8), (2, 3), (8, 2)])
def test_sample_meets_every_slot(batch, n):
    import random
    from harness.check import sample_proofs
    proofs = [(r, slot) for r in range(12) for slot in range(batch)]
    for seed in range(20):
        picked = sample_proofs(proofs, n, random.Random(seed))
        assert len(set(picked)) == len(picked) == max(n, batch)
        assert {proofs[i][1] for i in picked} == set(range(batch))


def test_verify_control_is_caught():
    r = _run("verify", "bound16", "accept")
    assert not r["correct"]
    assert r["checks"]["verdicts_wrong"]["value"] > 0


def test_prove_control_is_caught():
    r = _run("prove_batch", "hash16", "mimc485", requests=1)
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] > 0
