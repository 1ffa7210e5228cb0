"""One traced run of a benchmark cell with the port's own recorder on
(bulletproof_gadgets_tpu_torch.utils.profiling): where the card's idle
time goes by the innermost of the harness's and the program's spans, and
what per-layer readings of the program's spans and counters give.

    python3 scripts/trace_cell.py --workload merkle32.batch4 --seed 7 \
        --seconds 51 [--out FILE]

The run is benchmark/run.py's --trace 1 run (harness/runner.run, not
edited: the script wraps its window and its trace reading), with the
recorder enabled before set-up.  The harness's result line goes to
standard error; one JSON object goes to standard output (and --out): the
window, the requests' seconds, the counters' window deltas per request
(native.builds and engine.table_miss also under `built_in_window`: each
reads 0 where the warm-up built everything), the
program spans' seconds in the window by name (inclusive and self), the
set-up spans, the idle gaps by innermost span (harness and program, and
harness alone), the five readings, and the program's twins beside the
harness's spans.

A stopgap: it is deleted in the same change that turns the recorder on
in harness/runner.py's traced runs and moves the one-sweep attribution
(`idle_gaps` here) into harness/trace.idle_gaps, so that the benchmark
keeps one yardstick.
"""
import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, ".bench_cache",
                                             "nv_compute")
sys.path[:0] = [BENCH, ROOT]

from harness import runner, spec, trace                      # noqa: E402
from harness import traffic as traffic_mod                   # noqa: E402
from bulletproof_gadgets_tpu_torch.utils import profiling     # noqa: E402

# the spans of the R1CS prover and the lockstep driver, and those inside
# them that are waits on the device or the collector, not their host work
HOST = ("r1cs.", "lockstep.")
WAITS = ("readback", "gc")
TABLES = ("gens.map", "engine.table_build")
TWINS = (("batch.prepare", "prepare"), ("batch.image_hash", "image_hash"),
         ("ipa.create_batched", "ipa"))
BUILDS = ("native.builds", "engine.table_miss")


def innermost(spans, points):
    """The label of the innermost span (start, end, label) holding each
    point, None where none does.  Spans nest (one thread), so the innermost
    is the latest started of those still open."""
    order = sorted(range(len(points)), key=points.__getitem__)
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [None] * len(points), [], 0
    for k in order:
        p = points[k]
        while j < len(spans) and spans[j][0] <= p:
            s = spans[j]
            j += 1
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            stack.append(s)
        while stack and stack[-1][1] <= p:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def idle_gaps(merged, t0, t1, spans):
    """trace.idle_gaps's attribution ({label: seconds}) in one sweep, for
    the program's ~10^5 spans."""
    gaps, reach = [], t0
    for s, e in merged:
        if s > reach:
            gaps.append((reach, min(s, t1)))
        reach = max(reach, e)
    if reach < t1:
        gaps.append((reach, t1))
    gaps = [(s, e) for s, e in gaps if e > s]
    labels = innermost(spans, [(s + e) // 2 for s, e in gaps])
    out = {}
    for (s, e), label in zip(gaps, labels):
        key = "host: " + (label or "outside the spans")
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _ancestors(spans, i):
    p = spans[i][3]
    while p is not None:
        yield spans[p]
        p = spans[p][3]


def outermost_seconds(spans, keep, window=None):
    """Seconds of the spans `keep` selects, each counted once: a span
    inside another selected span is left out."""
    total = 0
    for i, s in enumerate(spans):
        if s[2] is None or not keep(s[0]):
            continue
        if window and not (window[0] <= s[1] and s[2] <= window[1]):
            continue
        if any(keep(a[0]) for a in _ancestors(spans, i)):
            continue
        total += s[2] - s[1]
    return total / 1e9


def host_seconds(spans, window):
    """r1cs.* and lockstep.* seconds less the readback and gc spans inside
    them."""
    def host(n):
        return n.startswith(HOST)
    total = outermost_seconds(spans, host, window)
    for i, s in enumerate(spans):
        if s[2] is None or s[0] not in WAITS:
            continue
        if not (window[0] <= s[1] and s[2] <= window[1]):
            continue
        up = [a[0] for a in _ancestors(spans, i)]
        if any(host(n) for n in up) and not any(n in WAITS for n in up):
            total -= (s[2] - s[1]) / 1e9
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    profiling.enable()
    cell = spec.load(args.workload)

    seen = {}
    real_window = traffic_mod.Traffic.window

    def window(self, seconds, requests=None):
        before = profiling.snapshot()["counters"]
        reqs = real_window(self, seconds, requests)
        after = profiling.snapshot()["counters"]
        seen["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                            if v != before.get(k, 0)}
        seen["requests"] = len(reqs)
        seen["proofs"] = sum(self.done(r) for r in reqs)
        seen["request_s"] = [r.returned - r.issued for r in reqs]
        return reqs

    real_context = runner._trace_context

    def context(cell, traffic, reqs, rec, prof, t0_ns, t1_ns):
        profiling.disable()
        events = [(max(s, t0_ns), min(e, t1_ns))
                  for _, s, e in prof.device_events()
                  if e > t0_ns and s < t1_ns]
        seen["merged"] = trace.device_activity(
            [("", s, e) for s, e in events])[1]
        seen["harness"] = {k: list(v) for k, v in rec.spans.items()}
        seen["window"] = (t0_ns, t1_ns)
        return real_context(cell, traffic, reqs, rec, prof, t0_ns, t1_ns)

    traffic_mod.Traffic.window = window
    runner._trace_context = context
    try:
        result = runner.run(cell, args.seed, args.seconds, True, T_START)
    finally:
        traffic_mod.Traffic.window = real_window
        runner._trace_context = real_context
        profiling.disable()
    print(json.dumps(result), file=sys.stderr, flush=True)

    spans = profiling.snapshot()["spans"]
    w = seen["window"]
    proofs, reqs, counters = seen["proofs"], seen["requests"], seen["counters"]
    harness = seen["harness"]
    program = [(s[1], s[2], s[0]) for s in spans
               if s[2] is not None and w[0] <= s[1] and s[2] <= w[1]]
    harness_spans = [(s, e, n) for n, lst in harness.items() for s, e in lst]
    out = {"workload": args.workload, "seed": args.seed,
           "gpu": trace.gpu_state(), "window_s": (w[1] - w[0]) / 1e9,
           "requests": reqs, "proofs": proofs,
           "request_s": seen["request_s"],
           "metrics": result["metrics"], "correct": result["correct"],
           "counters_per_request": {k: v / reqs for k, v in counters.items()},
           "built_in_window": {k: counters.get(k, 0) for k in BUILDS},
           "spans": profiling.totals(spans, w[0], w[1]),
           "setup_spans": profiling.totals(spans, 0, w[0]),
           "idle_gaps": idle_gaps(seen["merged"], w[0], w[1],
                                  program + harness_spans),
           "idle_gaps_harness_only": idle_gaps(seen["merged"], w[0], w[1],
                                               harness_spans),
           "readings": {
               "r1cs_host_s_per_proof": host_seconds(spans, w) / proofs,
               "readback_wait_s_per_proof": outermost_seconds(
                   spans, lambda n: n == "readback", w) / proofs,
               "readbacks_per_proof": counters.get("readbacks", 0) / proofs,
               "gc_s_per_proof": outermost_seconds(
                   spans, lambda n: n == "gc", w) / proofs,
               "setup_tables_s": outermost_seconds(
                   spans, lambda n: n in TABLES, (0, w[0]))},
           "twins": {}}
    for mine, theirs in TWINS:
        a = outermost_seconds(spans, lambda n: n == mine, w)
        b = sum(e - s for s, e in harness.get(theirs, [])) / 1e9
        out["twins"][f"{mine} / {theirs}"] = [a, b, a / b if b else None]
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
