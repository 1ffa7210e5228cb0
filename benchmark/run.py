"""Run one cell of the benchmark once and print its result as the last line
of standard output (see README.md):

    python3 benchmark/run.py --workload merkle32.batch4 --seed 7 \
        --seconds 51 --trace 0

Needs CUDA and the port, bulletproof_gadgets_tpu_torch, beside this folder;
without either it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse                                              # noqa: E402
import json                                                  # noqa: E402
import os                                                    # noqa: E402
import sys                                                   # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the driver's JIT cache at a fixed path inside the checkout (the port's
# kernels build into its own _build/ there)
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache",
                                             "nv_compute")
sys.path[:0] = [BENCH, ROOT]

from harness import runner, spec                             # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        T_START)
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
