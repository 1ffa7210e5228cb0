"""Where the PyTorch port's prove and verify time goes, on one NVIDIA GPU.

    python3 scripts/profile_port.py [--statement example] [--out FILE]

Proves and verifies one pinned statement of tests/port_pins.json once cold,
then --reps times warm (end-to-end wall times), then once warm with every
MSM stage timed on the host clock around a `torch.cuda.synchronize()`
(digit recode, plan incl. its count readback, each kernel, the result
readback), then once warm under torch.profiler for the device busy time:
the union of the card's own activity intervals (kernels, copies, memsets),
so no host operator is counted beside the device work it issued.
Prints one JSON object (also written to --out).
"""
import argparse
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_activity(prof):
    """(busy ms, {name: ms}) of the device-side events of a profile: the
    busy time is the union of their intervals, so overlap counts once."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start, end = e.start_ns(), e.end_ns()
            spans.append((start, end))
            key = e.name()[:60]
            by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e6
    busy_ns, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    return busy_ns / 1e6, by_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--statement", default="example")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.ops import engine, msm_serial as ms
    from bulletproof_gadgets_tpu_torch.utils import rng

    with open(os.path.join(ROOT, "tests", "port_pins.json")) as f:
        pins = json.load(f)
    st = pins["statements"][args.statement]
    engine.register("cuda")

    def run():
        rng.set_seed(pins["seed"])
        coms = []
        t0 = time.perf_counter()
        proof, _ = prove(args.statement, st["instance"], st["witness"],
                         st["gadgets"], coms)
        t1 = time.perf_counter()
        assert verify(args.statement, st["instance"], proof, "".join(coms),
                      st["gadgets"])
        return t1 - t0, time.perf_counter() - t1

    t0 = time.perf_counter()
    cold = run()                                       # gens, table, template
    cold_total = time.perf_counter() - t0
    warm = [run() for _ in range(args.reps)]

    stage_s = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    names = ("signed_digits", "plan", "bucket_accumulate", "bucket_merge",
             "window_sums", "horner", "points_from_cols", "msm_many")
    saved = {n: getattr(ms, n) for n in names}
    for n in names:
        setattr(ms, n, timed(n, saved[n]))
    launches0 = dict(ms.LAUNCHES)
    prove_s, verify_s = run()
    for n in names:
        setattr(ms, n, saved[n])
    msms = ms.LAUNCHES["horner"] - launches0["horner"]

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, by_name = device_activity(prof)
    if busy_ms == 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])

    res = {"statement": args.statement, "device": torch.cuda.get_device_name(0),
           "cold_prove_s": cold[0], "cold_verify_s": cold[1],
           "cold_total_s": cold_total,
           "warm_prove_s": sorted(w[0] for w in warm),
           "warm_verify_s": sorted(w[1] for w in warm),
           "instrumented_prove_s": prove_s,
           "instrumented_verify_s": verify_s,
           "msms": msms, "stage_s": stage_s,
           "profiled_wall_s": wall, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / 1e3 / wall,
           "top_device_ms": top}
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
