"""Freeze the proof pins that the PyTorch port is held against.

Proves six inline statements with the JAX package on the CPU, every MSM on
the host (`core.msm.set_table_min_size(1 << 30)` keeps the generator tables
off the device), under one fixed blinding seed, verifies each proof, and
writes `tests/port_pins.json`: the statement texts (gadgets, instance and
witness, with Merkle roots and hash images computed by `models/mimc`), the
circuit sizes and the sha256 of the proof and of the `.coms` text.

    python scripts/freeze_port_pins.py                 # all six (an hour)
    python scripts/freeze_port_pins.py --only bound16  # a subset
    python scripts/freeze_port_pins.py --batch         # the batch pins
    python scripts/freeze_port_pins.py --stress        # merkle_tree4

`--batch` writes the batch pins instead (under "batches"): three 16-bit
BOUND witnesses proved by the JAX package's `lang.batch.prove_batch` under
the same seed, once on the host table (`batch_bound16x3_host`) and once
with the generator table forced onto the device path
(`set_table_min_size(8)`: the lockstep protocol with its combined
commitment MSM, t-poly fetch and grouped IPA, the Pallas kernels in
interpret mode; `batch_bound16x3_table`).  `--stress` writes the stress family's pin (under "stress"): the
statement of the JAX package's scripts/run_stress_512.py at 4 leaves
(`Hash(Hash(W, W), Hash(W, W))` over four copies of its leaf MW1, the
root computed by `models/mimc`, BulletproofGens(2048 * leaves)), driven
through `Prover.prove_gen` as that script drives it, under its own seed
"stress-512", with host MSMs (~2 min); the port's
scripts/run_stress_512_torch.py --leaves 4 must give its bytes.  A batch's
bytes are not those of sequential proves: every witness is prepared (its commitments' blindings
drawn) before any proof starts, and on a device table the lockstep draws
every proof's commitment blindings before any proof's t-poly blindings.

The nine-line `example` pads to 2^14 generators and its host MSMs over the
32,770-point table take minutes; `merkle32` (a depth-5 MiMC Merkle
membership) pads to 2^16 generators, a 131,074-point table, and takes tens
of minutes.  The two OR statements (`or_flat`: three clauses, BOUND, EQUALS
and UNEQUAL, the EQUALS one false; `or_nested`: a BOUND and a nested
OR of EQUALS and UNEQUAL against a false EQUALS) take seconds; `or_flat`
is proved a second time with its generator table forced onto the device
path (`set_table_min_size(8)`, the Pallas kernels in interpret mode,
minutes), and the two proofs must be byte-equal.
"""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from bulletproof_gadgets_tpu.core import msm as core_msm  # noqa: E402
from bulletproof_gadgets_tpu.core.scalar import Scalar  # noqa: E402
from bulletproof_gadgets_tpu.lang.prove import (  # noqa: E402
    prove, prove_prepared, round_pow2)
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


# the OR statements' assignments: W0 in [I0, I1], W1 != I2 (a false EQUALS
# clause), W2 != I3, W0 != I4
OR_INSTANCE = _lines((k, bytes.fromhex(v)) for k, v in (
    ("I0", "0010"), ("I1", "1000"), ("I2", "07"), ("I3", "0539"),
    ("I4", "2a")))
OR_WITNESS = _lines((k, bytes.fromhex(v)) for k, v in (
    ("W0", "0539"), ("W1", "08"), ("W2", "09")))

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
    "or_flat": lambda: ("OR [\n{\nBOUND W0 I0 I1\n}\n{\nEQUALS W1 I2\n}\n"
                        "{\nUNEQUAL W2 I3\n}\n]\n", OR_INSTANCE, OR_WITNESS),
    "or_nested": lambda: ("OR [\n{\nBOUND W0 I0 I1\nOR [\n{\nEQUALS W1 I2\n}"
                          "\n{\nUNEQUAL W2 I3\n}\n]\n}\n{\nEQUALS W0 I4\n}"
                          "\n]\n", OR_INSTANCE, OR_WITNESS),
}
# statements also proved on a device table forced small (their bytes must
# not depend on the table's path)
DEVICE_TABLE_TOO = {"or_flat"}


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
    if name in DEVICE_TABLE_TOO:
        core_msm.set_table_min_size(8)
        rng.set_seed(SEED)
        dev_coms: list = []
        try:
            dev_proof, _ = prove(name, instance, witness, gadgets, dev_coms)
        finally:
            rng.set_seed(None)
            core_msm.set_table_min_size(1 << 30)
        assert (dev_proof, "".join(dev_coms)) == (proof, coms_text), \
            f"{name}: the device table's proof differs from the host's"
        print(f"{name}: byte-equal on a device table", flush=True)
    return {"gadgets": gadgets, "instance": instance, "witness": witness,
            "multipliers": n_mult, "constraints": num_constraints,
            "gens": round_pow2(n_mult),
            "proof_len": len(proof),
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "coms_sha256": hashlib.sha256(coms_text.encode()).hexdigest()}


# three 16-bit BOUND witnesses of the bound16 statement (0x0539 is its own)
BATCH_WITNESSES = ["W0 = 0x0539\n", "W0 = 0x0042\n", "W0 = 0x0fff\n"]
BATCHES = {"batch_bound16x3_host": 1 << 30, "batch_bound16x3_table": 8}


def freeze_batch(pin: str) -> dict:
    from bulletproof_gadgets_tpu.lang.batch import prove_batch, verify_batch
    gadgets, instance, _ = STATEMENTS["bound16"]()
    core_msm.set_table_min_size(BATCHES[pin])
    rng.set_seed(SEED)
    t0 = time.time()
    try:
        results = prove_batch("bound16", instance, BATCH_WITNESSES, gadgets)
    finally:
        rng.set_seed(None)
    t_prove = time.time() - t0
    oks = verify_batch("bound16", instance,
                       [(p, c) for p, _, c in results], gadgets)
    core_msm.set_table_min_size(1 << 30)
    assert oks == [True] * len(results), \
        f"{pin}: the JAX package rejects its own proofs {oks}"
    print(f"{pin}: {len(results)} proofs, prove_batch {t_prove:.1f} s",
          flush=True)
    return {"name": "bound16", "gadgets": gadgets, "instance": instance,
            "witnesses": BATCH_WITNESSES, "table_min_size": BATCHES[pin],
            "proof_sha256": [hashlib.sha256(p).hexdigest()
                             for p, _, _ in results],
            "coms_sha256": [hashlib.sha256(c.encode()).hexdigest()
                            for _, _, c in results]}


# the stress family (the JAX package's scripts/run_stress_512.py) at a
# leaf count whose proof the host MSMs make in minutes
STRESS = {"merkle_tree4": 4}
STRESS_SEED = "stress-512"
STRESS_LEAF = bytes.fromhex(
    "0522a64d7b931e21760cf955a15fcc793e8a52b42a56ab03afddec8beb668749")


def freeze_stress(name: str) -> dict:
    from bulletproof_gadgets_tpu.core.commitments import (
        commit_all_single, verifier_commit)
    from bulletproof_gadgets_tpu.core.gens import (BulletproofGens,
                                                   PedersenGens)
    from bulletproof_gadgets_tpu.core.lc import to_lc
    from bulletproof_gadgets_tpu.core.r1cs import Prover, Verifier
    from bulletproof_gadgets_tpu.models.merkle_tree import (MerkleTree256,
                                                            Hash, W)
    from bulletproof_gadgets_tpu.utils.conversions import be_to_scalar
    from bulletproof_gadgets_tpu.utils.merlin import Transcript
    leaves = STRESS[name]
    pat = Hash(W, W)
    for _ in range(leaves.bit_length() - 2):
        pat = Hash(pat, pat)
    node = be_to_scalar(STRESS_LEAF).v
    for _ in range(leaves.bit_length() - 1):
        node = mimc_sponge([node, node])
    root = to_lc(Scalar(node))
    rng.set_seed(STRESS_SEED)
    t0 = time.time()
    try:
        pc = PedersenGens.default()
        bp = BulletproofGens(2048 * leaves, 1)
        prover = Prover(pc, Transcript(b"MerkleTree"))
        _, coms, variables = commit_all_single(prover, [STRESS_LEAF] * leaves)
        MerkleTree256(root, [], [v.lc() for v in variables],
                      pat).prove(prover, [], [])
        gen = prover.prove_gen(bp)
        resp = None
        while True:                 # scripts/run_stress_512.py's loop
            try:
                kind, table, dig = gen.send(resp)
            except StopIteration as stop:
                proof = stop.value.to_bytes()
                break
            if kind == "msm":
                resp = table.msm_digits(dig)
            elif kind == "msm_enc":
                resp = table.msm_digits_enc_finish(
                    table.msm_digits_enc_launch(dig))
            elif kind == "fused_ipa":
                from bulletproof_gadgets_tpu.ops import ipa_fused
                resp = ipa_fused.create(dig[0], table, *dig[1:])
            else:
                resp = np.asarray(dig)
        t_prove = time.time() - t0
        verifier = Verifier(Transcript(b"MerkleTree"))
        w_vars = verifier_commit(verifier, coms)
        MerkleTree256(root, [], [v.lc() for v in w_vars],
                      pat).verify(verifier, w_vars, [])
        from bulletproof_gadgets_tpu.core.proof import R1CSProof
        verifier.verify(R1CSProof.from_bytes(proof), pc, bp)   # raises
    finally:
        rng.set_seed(None)
    print(f"{name}: {prover.get_num_multiplications()} multipliers, "
          f"{prover.num_constraints()} constraints, prove {t_prove:.1f} s",
          flush=True)
    return {"leaves": leaves, "seed": STRESS_SEED, "gens": 2048 * leaves,
            "constraints": prover.num_constraints(),
            "multipliers": prover.get_num_multiplications(),
            "proof_len": len(proof),
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "coms_sha256": hashlib.sha256(b"".join(coms)).hexdigest()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(STATEMENTS))
    ap.add_argument("--batch", action="store_true",
                    help="freeze the batch pins only")
    ap.add_argument("--stress", action="store_true",
                    help="freeze the stress family's pin only")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    core_msm.set_table_min_size(1 << 30)
    pins = {"seed": SEED, "statements": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            pins = json.load(f)
        assert pins["seed"] == SEED, "pins were frozen under another seed"
    if args.batch:
        jobs = [("batches", pin, freeze_batch) for pin in BATCHES]
    elif args.stress:
        jobs = [("stress", name, freeze_stress) for name in STRESS]
    else:
        jobs = [("statements", name, freeze)
                for name in args.only or list(STATEMENTS)]
    for group, name, fn in jobs:
        pins.setdefault(group, {})[name] = fn(name)
        with open(args.out, "w") as f:
            json.dump(pins, f, indent=1, sort_keys=True)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
