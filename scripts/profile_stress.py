"""The stress circuit's record on one NVIDIA GPU for the port package of a
given checkout, so that two checkouts (e.g. two MSM planners) can be
compared one after the other on one card:

    python3 scripts/profile_stress.py [--root DIR] [--label NAME]
        [--leaves 512] [--out FILE]

--root is the directory holding `bulletproof_gadgets_tpu_torch` and
`scripts/run_stress_512_torch.py` (default: this checkout).  Runs the
stress circuit once (run_stress_512_torch.run, `rows` layout) while
recording its table MSMs (the commitments' k = 3 digits and the
verifier's k = 1 digits over the whole table), then, on those digits:
the whole MSM under `rows` and `cols` (CUDA events, mean of 3 after a
warm-up, peak device memory above the inputs; equal points required) and
K1's ns per live entry on the first 2^17-point chunk.  Prints the stress
run's phase lines and one JSON line (label, the card's name and power
limit, the record), also written to --out.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPS = 3


def timed(fn, reps=REPS):
    """Mean ms per call (CUDA events) after one warm-up, and the last
    output."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def points(ms, out):
    """An MSM's points [4, NL, k] from msm_digits_t's output (a tensor in
    checkouts with the readback planner, (cols, excess) with the device
    schedule)."""
    return out[0] if isinstance(out, tuple) else out


def stress_record(run, ms, leaves, say=print, calls=None):
    """Run the stress circuit (`run` of run_stress_512_torch) while
    recording its whole-table MSMs (appended to `calls` as (digits, src,
    n) when a list is given), then time them under rows and cols.
    -> the record dict."""
    import torch
    calls = [] if calls is None else calls
    msm_digits_t = ms.msm_digits_t

    def record(digits, src, n, *a, **kw):
        if n > ms.POINT_CHUNK and digits.shape[0] != 2 * ms.W:
            calls.append((digits, src, n))     # not an IPA round
        return msm_digits_t(digits, src, n, *a, **kw)
    ms.msm_digits_t = record
    try:
        res = run(leaves, "rows", "cuda",
                  lambda tag, s: say(f"stress {leaves} leaves: {tag}: "
                                     f"{s:.3f} s"))
    finally:
        ms.msm_digits_t = msm_digits_t
    rec = {k: res[k] for k in ("constraints", "multipliers", "verify",
                                "tampered_verifies", "seconds", "rss_gb",
                                "device_peak_bytes")}
    rec["launches"] = {k: v for k, v in res["launches"].items() if v}
    rec["proof_sha256"] = hashlib.sha256(res["proof"]).hexdigest()
    rec["msms"] = {}
    for digits, src, n in calls:
        k = digits.shape[0] // ms.W
        label = f"k={k} over {n} points"
        if label in rec["msms"]:
            continue                       # the tampered copy's verify
        row = {}
        ref = None
        for layout in ("rows", "cols"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t_ms, out = timed(lambda: ms.msm_digits_t(digits, src, n,
                                                      layout=layout))
            out = points(ms, out)
            row[f"{layout}_ms"] = t_ms
            row[f"{layout}_peak_mib"] = (torch.cuda.max_memory_allocated()
                                         - base) / 2**20
            if ref is None:
                ref = out
            elif not torch.equal(out, ref):
                raise AssertionError(f"{label}: cols != rows")
        idx, _, _ = ms.plan(digits[:, :ms.POINT_CHUNK], n, 0)
        t_k1, _ = timed(lambda: ms.bucket_accumulate(src, idx))
        entries = int((idx != 2 * n).sum())
        row.update({"chunk_T": idx.shape[0], "chunk_P": idx.shape[1],
                    "chunk_entries": entries, "k1_ms": t_k1,
                    "k1_ns_per_entry": 1e6 * t_k1 / entries})
        rec["msms"][label] = row
        say(f"{label}: {row}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--leaves", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_stress: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    import run_stress_512_torch as stress
    from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms
    t0 = time.time()
    rec = stress_record(stress.run, ms, args.leaves)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    line = json.dumps({"label": args.label, "package": os.path.dirname(
        os.path.dirname(ms.__file__)), "card": smi[0] if smi else
        torch.cuda.get_device_name(0), "seconds": time.time() - t0,
        "record": rec})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if rec["verify"] and not rec["tampered_verifies"] else 1


if __name__ == "__main__":
    sys.exit(main())
