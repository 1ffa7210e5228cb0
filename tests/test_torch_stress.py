"""The stress family (scripts/run_stress_512_torch.py, the port's
counterpart of the JAX package's scripts/run_stress_512.py).

On the CPU: the statement's shape, and its 512-leaf root computed by the
port's MiMC against the JAX script's constant.  On the card (cuda-marked):
the 4-leaf statement driven through `Prover.prove_gen` on a device table,
byte-equal to `merkle_tree4` of tests/port_pins.json (frozen from the JAX
package's prove_gen with host MSMs by scripts/freeze_port_pins.py
--stress), verifying, and a tampered copy rejected.
"""
import hashlib
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import run_stress_512_torch as stress  # noqa: E402

PIN = json.loads((ROOT / "tests" / "port_pins.json").read_text())[
    "stress"]["merkle_tree4"]


def test_root_and_pattern():
    assert repr(stress.pattern(4)) == "H(H('W' 'W') H('W' 'W'))"
    assert stress.root_of(512) == int(stress.ROOT_512, 16)
    for bad in (1, 3, 6):
        with pytest.raises(ValueError):
            stress.pattern(bad)


@pytest.mark.cuda
def test_merkle_tree4_matches_its_pin():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    res = stress.run(PIN["leaves"], "rows", "cuda")
    assert hashlib.sha256(res["proof"]).hexdigest() == PIN["proof_sha256"]
    assert hashlib.sha256(res["coms"]).hexdigest() == PIN["coms_sha256"]
    assert (res["constraints"], res["multipliers"]) == \
        (PIN["constraints"], PIN["multipliers"])
    assert res["verify"] and not res["tampered_verifies"]
