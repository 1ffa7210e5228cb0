"""Where the PyTorch port's prove and verify time goes, on one NVIDIA GPU.

    python3 scripts/profile_port.py [--statement merkle32] [--out FILE]
    python3 scripts/profile_port.py --ipa example,merkle32 --batch example \
        [--root DIR] [--label NAME]

Proves and verifies one pinned statement of tests/port_pins.json once cold,
then --reps times warm (end-to-end wall times), then once warm with every
stage timed on the host clock around a `torch.cuda.synchronize()`: the MSM
stages (host digit recode, the device schedule, the idx rows, each
kernel, the result readback; `msm_digits_t[m]` is one device-digit MSM over an m-point
table, point-chunked past msm_serial.POINT_CHUNK points, its chunks
combined by K7 `point_sum`), the device vectors (`flatten.flatten`, the
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

--ipa (a comma-separated list of pinned statements) times the inner-product
argument alone instead: one warm prove records the arguments of
`ipa_fused.create` (the host transcript copied before the call), which are
then replayed --reps times (host clock around a synchronize: seconds per
argument), once counting readbacks (`Tensor.cpu`, `.item`, `.tolist` and
`bool` of CUDA tensors) and synchronizing calls (torch.cuda sync debug
mode), and once under torch.profiler (device busy time and idle share).
--batch STATEMENT does the same for `ipa_fused.create_batched` of a batch of
three proofs of the statement (lang.batch.prove_batch).  --root is the
directory holding `bulletproof_gadgets_tpu_torch` (default: this checkout),
so that two checkouts can be measured in turns on one card.
"""
import argparse
import functools
import importlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _copy_transcripts(ts):
    """A transcript (or a list of them) at the same STROBE state: the C
    transcript keeps its state in a ctypes buffer, which deepcopy cannot
    copy, so a new one of the same class takes the state."""
    if isinstance(ts, (list, tuple)):
        return [_copy_transcripts(t) for t in ts]
    dup = type(ts)(b"")
    dup.set_strobe_state(*ts.strobe_state())
    return dup


def _replay(fn, record, reps):
    """Time, count and profile `fn` on the recorded arguments (a fresh
    copy of their host transcripts each run) -> a dict of results."""
    import warnings
    import torch

    def run():                  # the transcripts copied before the clock
        args = (_copy_transcripts(record[0]),) + tuple(record[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    run()
    secs = []
    for _ in range(reps):
        out, sec = run()
        secs.append(sec)
    counts = {}
    saved = {}
    for name in ("cpu", "item", "tolist", "__bool__"):
        real = getattr(torch.Tensor, name)
        saved[name] = real

        def spy(self, *a, _real=real, _name=name, **kw):
            if self.is_cuda:
                counts[_name] = counts.get(_name, 0) + 1
            return _real(self, *a, **kw)
        setattr(torch.Tensor, name, spy)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for name, real in saved.items():
            setattr(torch.Tensor, name, real)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()[1]
    busy_ms, _ = device_activity(prof)
    rounds = len((out[0] if isinstance(out, list) else out)[0])
    readbacks = sum(counts.values())
    return {"s_per_call": sorted(secs), "rounds": rounds,
            "readbacks": counts, "readbacks_per_round": readbacks / rounds,
            "syncs": syncs, "syncs_per_round": syncs / rounds,
            "profiled_wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / 1e3 / wall}


def ipa_main(args, pins):
    """--ipa / --batch: the argument alone, replayed (module docstring)."""
    import torch
    from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.ops import engine, ipa_fused
    from bulletproof_gadgets_tpu_torch.utils import rng
    engine.register("cuda")
    res = {"label": args.label, "root": os.path.abspath(args.root),
           "device": torch.cuda.get_device_name(0), "ipa": {},
           "batch": {}}
    for attr, names, key in (("create", args.ipa, "ipa"),
                             ("create_batched", args.batch, "batch")):
        real = getattr(ipa_fused, attr)
        for name in filter(None, (names or "").split(",")):
            st = pins["statements"][name]
            records = []

            def spy(*a, **kw):
                records.append((_copy_transcripts(a[0]),) + a[1:])
                return real(*a, **kw)
            rng.set_seed(pins["seed"])
            if key == "ipa":
                prove(name, st["instance"], st["witness"], st["gadgets"], [])
            else:
                prove_batch(name, st["instance"], [st["witness"]] * 3,
                            st["gadgets"])
            setattr(ipa_fused, attr, spy)
            try:
                rng.set_seed(pins["seed"])
                if key == "ipa":
                    prove(name, st["instance"], st["witness"],
                          st["gadgets"], [])
                else:
                    prove_batch(name, st["instance"], [st["witness"]] * 3,
                                st["gadgets"])
            finally:
                setattr(ipa_fused, attr, real)
            rng.set_seed(None)
            res[key][name] = _replay(real, records[0], args.reps)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--statement", default="merkle32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ipa", default=None)
    ap.add_argument("--batch", default=None)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "tests", "port_pins.json")) as f:
        pins = json.load(f)
    if args.ipa or args.batch:
        return _emit(ipa_main(args, pins), args.out)
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.core import r1cs
    from bulletproof_gadgets_tpu_torch.ops import (
        engine, flatten, ipa_fold, ipa_fused, msm_serial as ms,
        prover_device, verifier_device)
    from bulletproof_gadgets_tpu_torch.utils import rng

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
        "signed_digits", "schedule", "idx_rows", "bucket_accumulate",
        "bucket_accumulate_cont", "bucket_merge",
        "window_sums", "point_sum", "horner", "points_from_cols",
        "msm_many", "msm_digits_t")] + [
        (flatten, "flatten"), (prover_device, "commitment_digits"),
        (pv, "__init__"), (pv, "t_poly"), (pv, "lr"), (pv, "factors"),
        (verifier_device, "table_digits_dev"),
        (r1cs.Prover, "_flattened_constraints"),
        (r1cs.Verifier, "_flattened_constraints"), (r1cs, "exp_iter"),
        (ipa_fused, "create"), (ipa_fused, "_fold"), (ipa_fused, "_scalars"),
        (ipa_fold, "materialize")]
    for mod_name, n in (("ristretto_device", "ristretto_compress"),
                        ("strobe_device", "transcript_round")):
        if importlib.util.find_spec(
                f"bulletproof_gadgets_tpu_torch.ops.{mod_name}"):
            stages.append((importlib.import_module(
                f"bulletproof_gadgets_tpu_torch.ops.{mod_name}"), n))
    stages = [(mod, n) for mod, n in stages if hasattr(mod, n)]
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
    return _emit(res, args.out)


def _emit(res, out):
    line = json.dumps(res)
    print(line)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
