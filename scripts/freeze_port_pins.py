"""Freeze the proof pins that the PyTorch port is held against.

Proves four inline statements with the JAX package on the CPU, every MSM on
the host (`core.msm.set_table_min_size(1 << 30)` keeps the generator tables
off the device), under one fixed blinding seed, verifies each proof, and
writes `tests/port_pins.json`: the statement texts (gadgets, instance and
witness, with Merkle roots and hash images computed by `models/mimc`), the
circuit sizes and the sha256 of the proof and of the `.coms` text.

    python scripts/freeze_port_pins.py                 # all four (an hour)
    python scripts/freeze_port_pins.py --only bound16  # a subset

The nine-line `example` pads to 2^14 generators and its host MSMs over the
32,770-point table take minutes; `merkle32` (a depth-5 MiMC Merkle
membership) pads to 2^16 generators, a 131,074-point table, and takes tens
of minutes.
"""
import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from bulletproof_gadgets_tpu.core import msm as core_msm  # noqa: E402
from bulletproof_gadgets_tpu.core.scalar import Scalar  # noqa: E402
from bulletproof_gadgets_tpu.lang.prove import (  # noqa: E402
    prove_prepared, round_pow2)
from bulletproof_gadgets_tpu.lang.verify import verify  # noqa: E402
from bulletproof_gadgets_tpu.models.mimc import (  # noqa: E402
    mimc_hash, mimc_sponge)
from bulletproof_gadgets_tpu.utils import rng  # noqa: E402
from bulletproof_gadgets_tpu.utils.conversions import scalar_to_be  # noqa: E402

SEED = "bpg-port-pins"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "port_pins.json")


def _lines(pairs):
    return "".join(f"{k} = 0x{v.hex()}\n" for k, v in pairs)


def _example():
    """The reference's nine-line `example.gadgets` with a satisfying
    instance and witness."""
    gadgets = ("EQUALS W0 W1\n"
               "BOUND W1 I0 I1\n"
               "HASH W2 W1\n"
               "MERKLE I2 (W1 I3)\n"
               "MERKLE I7 (I6 W4)\n"
               "MERKLE I5 ((W1 I3) (I6 W4))\n"
               "UNEQUAL W3 I4\n"
               "SET_MEMBER W0 I0 I1 W1 I7\n"
               "LESS_THAN W4 W0\n")
    w1 = bytes.fromhex("0539")
    w4 = bytes.fromhex("2a")
    i3 = bytes.fromhex("0b0b")
    i6 = bytes.fromhex("0c0c0c")
    h = lambda b: mimc_hash(b).v                       # noqa: E731
    node = lambda *xs: mimc_sponge(list(xs))           # noqa: E731
    be = lambda v: scalar_to_be(Scalar(v))             # noqa: E731
    left = node(h(w1), h(i3))
    right = node(h(i6), h(w4))
    instance = [("I0", bytes.fromhex("0100")), ("I1", bytes.fromhex("1000")),
                ("I2", be(left)), ("I3", i3), ("I4", bytes.fromhex("08")),
                ("I5", be(node(left, right))), ("I6", i6), ("I7", be(right))]
    witness = [("W0", w1), ("W1", w1), ("W2", be(h(w1))),
               ("W3", bytes.fromhex("07")), ("W4", w4)]
    return gadgets, _lines(instance), _lines(witness)


def _merkle32():
    """Membership of witness leaf W0 in a depth-5 MiMC Merkle tree whose
    other 31 leaves are the instance I1..I31; the root is I0."""
    leaves = ["W0"] + [f"I{i}" for i in range(1, 32)]
    values = {"W0": bytes.fromhex("0539")}
    values.update({f"I{i}": bytes([i, 0x5a, i * 7 % 256])
                   for i in range(1, 32)})
    h = lambda b: mimc_hash(b).v                       # noqa: E731

    def tree(names):
        if len(names) == 1:
            return names[0], h(values[names[0]])
        half = len(names) // 2
        (lt, lv), (rt, rv) = tree(names[:half]), tree(names[half:])
        return f"({lt} {rt})", mimc_sponge([lv, rv])

    text, root = tree(leaves)
    instance = [("I0", scalar_to_be(Scalar(root)))]
    instance += [(f"I{i}", values[f"I{i}"]) for i in range(1, 32)]
    return (f"MERKLE I0 {text}\n", _lines(instance),
            _lines([("W0", values["W0"])]))


STATEMENTS = {
    # 16-bit BOUND: 32 multipliers, a 66-point table
    "bound16": lambda: ("BOUND W0 I0 I1\n",
                        _lines([("I0", bytes.fromhex("0010")),
                                ("I1", bytes.fromhex("1000"))]),
                        _lines([("W0", bytes.fromhex("0539"))])),
    # 379 multipliers, 512 gens, a 1026-point table
    "less_than": lambda: ("LESS_THAN W0 W1\n", "",
                          _lines([("W0", bytes.fromhex("2a")),
                                  ("W1", bytes.fromhex("0539"))])),
    "example": _example,
    # 61,236 multipliers, 2^16 gens, a 131,074-point table (two point
    # chunks on the port's device path)
    "merkle32": _merkle32,
}


def freeze(name: str) -> dict:
    gadgets, instance, witness = STATEMENTS[name]()
    rng.set_seed(SEED)
    coms: list = []
    t0 = time.time()
    prover, bp_gens, num_constraints = prove_prepared(
        name, instance, witness, gadgets, coms)
    n_mult = prover.get_num_multiplications()
    proof = prover.prove(bp_gens).to_bytes()
    t_prove = time.time() - t0
    coms_text = "".join(coms)
    ok = verify(name, instance, proof, coms_text, gadgets)
    rng.set_seed(None)
    assert ok, f"{name}: the JAX package rejects its own proof"
    print(f"{name}: {n_mult} multipliers, {num_constraints} constraints, "
          f"prove {t_prove:.1f} s", flush=True)
    return {"gadgets": gadgets, "instance": instance, "witness": witness,
            "multipliers": n_mult, "constraints": num_constraints,
            "gens": round_pow2(n_mult),
            "proof_len": len(proof),
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "coms_sha256": hashlib.sha256(coms_text.encode()).hexdigest()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(STATEMENTS))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    core_msm.set_table_min_size(1 << 30)
    pins = {"seed": SEED, "statements": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            pins = json.load(f)
        assert pins["seed"] == SEED, "pins were frozen under another seed"
    for name in args.only or list(STATEMENTS):
        pins["statements"][name] = freeze(name)
        with open(args.out, "w") as f:
            json.dump(pins, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
