"""The inner-product argument's time on two checkouts, in alternating runs
on one NVIDIA GPU.

    python3 scripts/compare_ipa.py --parent DIR [--change DIR] [--pairs 10]
        [--ipa example,merkle32] [--batch example] [--reps 5] [--out FILE]

Runs `scripts/profile_port.py --ipa ... --batch ...` (one process per run)
on the parent checkout and on the change (default: this checkout) in pairs
whose order alternates (parent, change, change, parent, ...), so that a
drift of the host over the call falls on both sides alike.  Each run
replays every argument --reps times after one warm prove (profile_port's
docstring).  Prints, and writes to --out, one JSON object: the runs as
profile_port gave them, and per argument and side the median of all
seconds per argument, the lowest and highest run median, readbacks and
synchronizing calls per round, device busy ms and idle share (medians over
runs), and the change's run median less its pair's parent run median
(median, lowest, highest over the pairs).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_once(root, label, args, tmp):
    out = os.path.join(tmp, f"{label}.json")
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "profile_port.py"),
           "--root", root, "--label", label, "--reps", str(args.reps),
           "--out", out]
    if args.ipa:
        cmd += ["--ipa", args.ipa]
    if args.batch:
        cmd += ["--batch", args.batch]
    res = subprocess.run(cmd, stdout=subprocess.DEVNULL,
                         stderr=subprocess.PIPE, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{label}: profile_port failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def summarize(runs):
    """{argument: {side: stats, "change_less_parent": stats}} over runs
    [(side, pair, result)]."""
    out = {}
    keys = sorted({(key, name) for _, _, r in runs
                   for key in ("ipa", "batch") for name in r[key]})
    for key, name in keys:
        arg = f"{name} x 3 batch" if key == "batch" else name
        per_side, run_med = {}, {}
        for side, pair, r in runs:
            res = r[key][name]
            run_med[(side, pair)] = statistics.median(res["s_per_call"])
            per_side.setdefault(side, []).append(res)
        out[arg] = {}
        for side, results in per_side.items():
            meds = [run_med[(s, p)] for s, p, _ in runs if s == side]
            out[arg][side] = {
                "s_median": statistics.median(
                    [t for res in results for t in res["s_per_call"]]),
                "run_median_min": min(meds), "run_median_max": max(meds),
                "runs": len(results),
                "readbacks_per_round": statistics.median(
                    res["readbacks_per_round"] for res in results),
                "syncs_per_round": statistics.median(
                    res["syncs_per_round"] for res in results),
                "device_busy_ms": statistics.median(
                    res["device_busy_ms"] for res in results),
                "device_idle_share": statistics.median(
                    res["device_idle_share"] for res in results)}
        pairs = sorted({p for _, p, _ in runs})
        diffs = [run_med[("change", p)] - run_med[("parent", p)]
                 for p in pairs]
        out[arg]["change_less_parent"] = {
            "median_s": statistics.median(diffs), "min_s": min(diffs),
            "max_s": max(diffs), "pairs": len(diffs),
            "change_faster_in": sum(d < 0 for d in diffs)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", default=ROOT)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--ipa", default="example,merkle32")
    ap.add_argument("--batch", default="example")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for pair in range(args.pairs):
            order = ("parent", "change") if pair % 2 == 0 else \
                ("change", "parent")
            for side in order:
                r = run_once(roots[side], f"{side}{pair}", args, tmp)
                runs.append((side, pair, r))
                print(f"pair {pair} {side} done", file=sys.stderr,
                      flush=True)
    res = {"device": runs[0][2]["device"], "pairs": args.pairs,
           "summary": summarize(runs),
           "runs": [dict(r, side=side, pair=pair) for side, pair, r in runs]}
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps(res["summary"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
