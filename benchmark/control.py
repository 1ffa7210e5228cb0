"""The comparison's control, run on the card at a cell's own size: sound
runs and runs with the control planted (harness/faults.py: `mimc485` for
prove cells, `accept` for verify cells), each a short window at the cell's
load, all in one process.  Prints one JSON line per run, then each number's
lower reading (the most any sound run gave) and upper reading (the least
any control run gave):

    python3 benchmark/control.py --workload merkle32.batch4 --seeds 11,12,13

A run makes as many requests as a run of the cell checks proofs
(check_proofs / batch), or verifies each set-up proof twice.
"""
import argparse
import json
import math
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from harness import faults, runner, spec                     # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    p = cell.traffic
    if p["kind"] == "verify":
        planted, requests = faults.VERIFY_CONTROL, 2 * p["proofs"]
    else:
        planted = faults.PROVE_CONTROL
        requests = math.ceil(p["check_proofs"] / p["batch"])
    seeds = [int(s) for s in args.seeds.split(",")]
    from bulletproof_gadgets_tpu_torch.models import mimc
    lower, upper = {}, {}
    for fault in (None,) + planted:
        for seed in seeds:
            mimc._image_cache.clear()
            t0 = time.perf_counter()
            r = runner.run(cell, seed, 0, False, t0, fault=fault,
                           requests=requests)
            row = {"seed": seed, "fault": fault, "correct": r["correct"],
                   "checks": {k: v["value"] for k, v in r["checks"].items()},
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            for k, v in row["checks"].items():
                if fault is None:
                    lower[k] = max(lower.get(k, 0), v)
                else:
                    upper.setdefault(fault, {})
                    upper[fault][k] = min(upper[fault].get(k, v), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
