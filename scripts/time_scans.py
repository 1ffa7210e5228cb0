"""Time the MSM's K4 (window_sums) and K5 (horner) kernels on one NVIDIA GPU
for the port package of a given checkout, so that two checkouts can be
compared in turns on one card:

    python3 scripts/time_scans.py [--root DIR] [--label NAME]

--root is the directory holding `bulletproof_gadgets_tpu_torch` (default:
this checkout); its kernels are built there at first use.  The inputs are
made from a seed: the bucket sums of an MSM of k random scalar vectors
over a 2,050-point generator table (k = 1, 3, 9: the verifier's, the
commitments' and three stacked proofs' launches), the same in every
checkout.  Both kernels are held against their plain versions (tolerance
0), then timed with CUDA events (mean of 20 launches after a warm-up).
Prints one JSON line: the label, the card's name and power limit, and the
ms of each kernel at each k.
"""
import argparse
import json
import os
import random
import subprocess
import sys

import numpy as np

N_GENS = 1024
KS = (1, 3, 9)
REPS = 20


def timed(fn):
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_scans: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms

    dev = torch.device("cuda")
    gens = BulletproofGens(N_GENS)
    pts = list(gens.G(N_GENS)) + list(gens.H(N_GENS)) + list(gens.G(2))
    n = len(pts)
    src = torch.from_numpy(ms.prep_source(pts)).to(dev)
    r = random.Random(7)
    res = {}
    for k in KS:
        vecs = [[r.randrange(L) for _ in range(n)] for _ in range(k)]
        digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
        d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
        idx, offs, sub = ms.plan(d.to(dev), n)
        buckets = ms.bucket_merge(ms.bucket_accumulate(src, idx), offs, sub)
        ws = ms.window_sums(buckets)
        if not (torch.equal(ws, ms.window_sums_plain(buckets)) and
                torch.equal(ms.horner(ws, k), ms.horner_plain(ws, k))):
            raise AssertionError(f"k={k}: a kernel differs from its plain "
                                 "version")
        res[f"k={k}"] = {
            "window_sums_ms": timed(lambda: ms.window_sums(buckets)),
            "horner_ms": timed(lambda: ms.horner(ws, k))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    package = os.path.dirname(os.path.dirname(ms.__file__))
    print(json.dumps({"label": args.label, "package": package,
                      "card": smi[0] if smi else torch.cuda.get_device_name(0),
                      "times": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
