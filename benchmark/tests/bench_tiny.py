"""A cell small enough for the CPU: a 16-bit BOUND (bound16) and a BOUND
with a HASH of the witness (hash16), proved by the port's plain versions."""
import types

from harness.spec import Cell


def _draw_bound(rng, cfg, batch):
    ws = [f"W0 = 0x{rng.randrange(0x0100, 0x1000):04x}\n"
          for _ in range(batch)]
    return "BOUND W0 I0 I1\n", "I0 = 0x0010\nI1 = 0x1000\n", ws


def _draw_hash(rng, cfg, batch):
    from reference.models.mimc import mimc_hash
    from reference.core.scalar import Scalar
    from reference.utils.conversions import scalar_to_be
    ws = []
    for _ in range(batch):
        w0 = rng.randrange(0x0100, 0x1000).to_bytes(2, "big")
        w1 = scalar_to_be(Scalar(mimc_hash(w0).v))
        ws.append(f"W0 = 0x{w0.hex()}\nW1 = 0x{w1.hex()}\n")
    return "HASH W1 W0\n", "", ws


def cell(kind="prove_batch", statement="bound16", **traffic):
    draw = {"bound16": _draw_bound, "hash16": _draw_hash}[statement]
    module = types.ModuleType(f"tiny_{statement}")
    module.draw = draw
    params = {"prove_batch": {"kind": "prove_batch", "batch": 2,
                              "fresh": True, "check_proofs": 3},
              "verify": {"kind": "verify", "proofs": 2, "tampered": 1}}[kind]
    params.update(traffic)
    e2e = [{"name": "proofs_per_s" if kind == "prove_batch"
            else "verifies_per_s", "unit": "1/s"},
           {"name": "setup_s", "unit": "s"}]
    return Cell(f"{statement}.{kind}", 1, {"name": statement}, module,
                params, e2e, [], {})
