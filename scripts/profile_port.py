"""Where the PyTorch port's prove and verify time goes, on one NVIDIA GPU.

    python3 scripts/profile_port.py [--statement merkle32] [--out FILE]

Proves and verifies one pinned statement of tests/port_pins.json once cold,
then --reps times warm (end-to-end wall times), then once warm with every
stage timed on the host clock around a `torch.cuda.synchronize()`: the MSM
stages (host digit recode, plan incl. its count readback, each kernel, the
result readback; `msm_digits_t[m]` is one device-digit MSM over an m-point
table, point-chunked past msm_serial.POINT_CHUNK points, its chunks
combined by K7 `point_add`), the device vectors (`flatten.flatten`, the
commitment digits, `ProverVectors` build / t_poly / lr / factors,
`verifier_device.table_digits_dev`), the host loops they replace
(`Prover._flattened_constraints`, `Verifier._flattened_constraints`,
`exp_iter`, `signed_digits`: absent from a device-path run), and the
device IPA's (`ipa_fused.create` in all, its folds `ipa_fold.materialize`,
its challenge folds `_fold` and digit builds `_scalars`).  Stages nest: an
IPA's MSMs are inside `ipa_fused.create`, and the kernels inside their
MSM; `stage_n` counts the calls.  Then once warm under torch.profiler
for the device busy time:
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
    ap.add_argument("--statement", default="merkle32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.core import r1cs
    from bulletproof_gadgets_tpu_torch.ops import (
        engine, flatten, ipa_fold, ipa_fused, msm_serial as ms,
        prover_device, verifier_device)
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

    stage_s, stage_n = {}, {}

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            key = name if name != "msm_digits_t" else f"{name}[{a[2]}]"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[key] = stage_s.get(key, 0.0) + time.perf_counter() - t0
            stage_n[key] = stage_n.get(key, 0) + 1
            return out
        return wrapper

    pv = prover_device.ProverVectors
    stages = [(ms, n) for n in (
        "signed_digits", "plan", "bucket_accumulate", "bucket_merge",
        "window_sums", "point_add", "horner", "points_from_cols",
        "msm_many", "msm_digits_t")] + [
        (flatten, "flatten"), (prover_device, "commitment_digits"),
        (pv, "__init__"), (pv, "t_poly"), (pv, "lr"), (pv, "factors"),
        (verifier_device, "table_digits_dev"),
        (r1cs.Prover, "_flattened_constraints"),
        (r1cs.Verifier, "_flattened_constraints"), (r1cs, "exp_iter"),
        (ipa_fused, "create"), (ipa_fused, "_fold"), (ipa_fused, "_scalars"),
        (ipa_fold, "materialize")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in stages]
    for mod, n, fn in saved:
        setattr(mod, n, timed(n if mod is ms else
                              f"{mod.__name__.rsplit('.', 1)[-1]}.{n}", fn))
    launches0 = dict(ms.LAUNCHES)
    prove_s, verify_s = run()
    for mod, n, fn in saved:
        setattr(mod, n, fn)
    launches = {k: ms.LAUNCHES[k] - launches0[k] for k in ms.LAUNCHES}

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
           "msms": launches["horner"], "launches": launches,
           "point_chunk": ms.POINT_CHUNK, "stage_s": stage_s,
           "stage_n": stage_n,
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
