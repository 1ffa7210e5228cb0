"""Time the MSM's K1 (bucket_accumulate), K8 (bucket_accumulate_cols), K3
(bucket_merge), K4 (window_sums) and K5 (horner) kernels, the fold's K6
(ladder_fold) and the IPA round's transcript_round (with challenge_rows,
its F_l part alone) and ristretto_compress on one NVIDIA GPU for the port
package of a given checkout, so that two checkouts can be compared in
turns on one card:

    python3 scripts/time_scans.py [--root DIR] [--label NAME] [--pins]

--root is the directory holding `bulletproof_gadgets_tpu_torch` (default:
this checkout); its kernels are built there at first use.  The inputs are
made from a seed, the same in every checkout: the plan (idx), its
gather_cols blocks and the bucket pool of an MSM of k scalar vectors over
a 2,050-point generator table (k = 1, 3, 9: the verifier's, the
commitments' and three stacked proofs' launches; the first vector is a bit
vector, whose one live bucket splits over the most pool lanes, as a
commitment's does), and folds of 2,048 and 8,192 outputs of 16
terms (the fold of a 2^14- and of a 2^16-gens table) with random table rows
and random windows; transcript_round on B = 1 and 8 host transcripts at
seeded STROBE positions with seeded L | R encodings, challenge_rows on one
seeded 64-byte string, ristretto_compress on k = 2 and 3 seeded points
with Z != 1 (the IPA round's and the commitments' launches).  Each
kernel is held against its plain version (tolerance 0), then timed with
CUDA events (mean of 20 launches after a warm-up, queued behind a device
sleep).  --pins adds K1 on
the pinned statements' own table MSMs: one prove + verify of less_than,
example and merkle32 (tests/port_pins.json) with the checkout's package
records the commitments' k = 3 and the verifier's k = 1 digits, and K1
runs on each point chunk's idx as that checkout's planner
(`msm_serial.plan`) lays it out.  Prints one JSON line: the label, the
card's name and power limit, the ms of each kernel at each shape, and
ptxas's registers, stack and spills of the two transcript kernels where
the process built the library.
"""
import argparse
import inspect
import json
import os
import random
import subprocess
import sys

import numpy as np

N_GENS = 1024
KS = (1, 3, 9)
FOLD_OUTPUTS = (2048, 8192)
FOLD_TERMS = 16
REPS = 20
SLEEP_CYCLES = 20_000_000   # ~10 ms of device time at 1.98 GHz
TRANSCRIPTS = (1, 8)
COMPRESS_KS = (2, 3)
PTXAS_KERNELS = ("transcript_round_kernel", "ristretto_compress_kernel")


def timed(fn):
    """Mean ms of REPS launches after a warm-up, queued behind a device
    sleep so that the events time the card, not the host's launch rate."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def fs_times(dev):
    """transcript_round (B = 1, 8), challenge_rows (B = 1) and
    ristretto_compress (k = 2, 3) on seeded inputs, each held against its
    plain version (tolerance 0) first: {name: ms}."""
    import torch
    from bulletproof_gadgets_tpu_torch.core.ristretto import (
        P, RISTRETTO_BASEPOINT, RistrettoPoint)
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.ops import fp
    from bulletproof_gadgets_tpu_torch.ops import ristretto_device as rd
    from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
    from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript
    rng, out = np.random.default_rng(12), {}
    for b in TRANSCRIPTS:
        ts = []
        for _ in range(b):
            t = Transcript(b"time-scans")
            t.append_message(b"V", rng.bytes(int(rng.integers(0, 166))))
            ts.append(t)
        state, meta = sd.snapshot(ts, dev)
        enc = torch.from_numpy(rng.integers(0, 256, (b, 2, 32),
                                            dtype=np.uint8)).to(dev)
        got = sd.transcript_round(state, meta, enc)
        want = sd.transcript_round_plain(state.cpu(), meta.cpu(), enc.cpu())
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"transcript_round B={b} differs from its "
                                 "plain version")
        out[f"transcript_round B={b}"] = timed(
            lambda: sd.transcript_round(state, meta, enc))
    ch = torch.from_numpy(rng.integers(0, 256, (1, 64), dtype=np.uint8))
    if not torch.equal(sd.challenge_rows(ch.to(dev)).cpu(),
                       sd.challenge_rows_plain(ch)):
        raise AssertionError("challenge_rows differs from its plain version")
    ch = ch.to(dev)
    out["challenge_rows B=1"] = timed(lambda: sd.challenge_rows(ch))
    r = random.Random(13)
    for k in COMPRESS_KS:
        pts = []
        for _ in range(k):
            q = RISTRETTO_BASEPOINT.scalar_mul(r.randrange(L))
            z = r.randrange(1, P)
            pts.append(RistrettoPoint(q.X * z, q.Y * z, q.Z * z, q.T * z))
        cols = torch.stack([torch.from_numpy(fp.ints_to_limbs(
            [getattr(p, c) for p in pts])) for c in "XYZT"]).to(dev)
        got = rd.ristretto_compress(cols)
        if [bytes(row) for row in got.cpu().numpy()] != [
                p.compress() for p in pts] or not torch.equal(
                    got, rd.compress_cols(cols)):
            raise AssertionError(f"ristretto_compress k={k} differs from "
                                 "its plain version or the host")
        out[f"ristretto_compress k={k}"] = timed(
            lambda: rd.ristretto_compress(cols))
    return out


def ptxas_usage(log, kernel):
    """ptxas's (-Xptxas -v) stack, spill and register lines for the kernel
    whose mangled name contains `kernel`."""
    lines, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = kernel in line
        elif mine and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines) or "not in the build log"


def pin_k1(ms, root):
    """K1 on the commitments' and the verifier's table MSMs of the pinned
    less_than, example and merkle32, per point chunk as this checkout
    plans them: {"pin NAME k=K": {"T", "P", "entries", "k1_ms"}}."""
    import torch
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.utils import rng
    with open(os.path.join(root, "tests", "port_pins.json")) as f:
        pins = json.load(f)
    calls, msm_digits_t = [], ms.msm_digits_t

    def record(digits, src, n, *a, **kw):
        calls.append((digits, src, n))
        return msm_digits_t(digits, src, n, *a, **kw)
    out = {}
    for name in ("less_than", "example", "merkle32"):
        st = pins["statements"][name]
        del calls[:]
        ms.msm_digits_t = record
        try:
            rng.set_seed(pins["seed"])
            coms = []
            proof, _ = prove(name, st["instance"], st["witness"],
                             st["gadgets"], coms)
            ok = verify(name, st["instance"], proof, "".join(coms),
                        st["gadgets"])
        finally:
            ms.msm_digits_t = msm_digits_t
            rng.set_seed(None)
        if not ok:
            raise AssertionError(f"{name}: verify returned false")
        for digits, src, n in (calls[0], calls[-1]):
            k = digits.shape[0] // ms.W
            row = {"T": [], "P": [], "entries": 0, "k1_ms": 0.0}
            for lo in range(0, n, ms.POINT_CHUNK):
                idx, _, _ = ms.plan(digits[:, lo:lo + ms.POINT_CHUNK], n, lo)
                if not torch.equal(ms.bucket_accumulate(src, idx),
                                   ms.bucket_accumulate_plain(src, idx)):
                    raise AssertionError(f"{name} k={k}: K1 differs from "
                                         "its plain version")
                row["T"].append(idx.shape[0])
                row["P"].append(idx.shape[1])
                row["entries"] += int((idx != 2 * n).sum())
                row["k1_ms"] += timed(lambda: ms.bucket_accumulate(src, idx))
            out[f"pin {name} k={k}"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--pins", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_scans: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.ops import ipa_fold
    from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms

    dev = torch.device("cuda")
    # checkouts before the generator map took a device expand on the host
    takes_device = "device" in inspect.signature(BulletproofGens).parameters
    gens = BulletproofGens(N_GENS, **({"device": dev} if takes_device
                                      else {}))
    pts = list(gens.G(N_GENS)) + list(gens.H(N_GENS)) + list(gens.G(2))
    n = len(pts)
    src = torch.from_numpy(ms.prep_source(pts)).to(dev)
    r = random.Random(7)
    res = {}
    for k in KS:
        vecs = [[r.randrange(2) for _ in range(n)]] + [
            [r.randrange(L) for _ in range(n)] for _ in range(k - 1)]
        digits = np.concatenate([ms.signed_digits(v, ms.C) for v in vecs], 1)
        d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
        idx, offs, sub = ms.plan(d.to(dev), n)
        g = ms.gather_cols(src, idx)
        pool = ms.bucket_accumulate(src, idx)
        buckets = ms.bucket_merge(pool, offs, sub)
        ws = ms.window_sums(buckets)
        if not (torch.equal(pool, ms.bucket_accumulate_plain(src, idx))
                and torch.equal(ms.bucket_accumulate_cols(g),
                                ms.bucket_accumulate_cols_plain(g))
                and torch.equal(buckets,
                                ms.bucket_merge_plain(pool, offs, sub))
                and torch.equal(ws, ms.window_sums_plain(buckets))
                and torch.equal(ms.horner(ws, k), ms.horner_plain(ws, k))):
            raise AssertionError(f"k={k}: a kernel differs from its plain "
                                 "version")
        res[f"k={k}"] = {
            "T": idx.shape[0], "P": idx.shape[1],
            "max_sub": int(sub.max()),
            "bucket_accumulate_ms": timed(
                lambda: ms.bucket_accumulate(src, idx)),
            "bucket_accumulate_cols_ms": timed(
                lambda: ms.bucket_accumulate_cols(g)),
            "bucket_merge_ms": timed(lambda: ms.bucket_merge(pool, offs, sub)),
            "window_sums_ms": timed(lambda: ms.window_sums(buckets)),
            "horner_ms": timed(lambda: ms.horner(ws, k))}
    rng = np.random.default_rng(9)
    for outputs in FOLD_OUTPUTS:
        base = torch.from_numpy(rng.integers(
            0, 2 * n, (FOLD_TERMS, outputs), dtype=np.int32)).to(dev)
        dig = torch.from_numpy(rng.integers(
            0, 16, (64 * FOLD_TERMS, outputs), dtype=np.int32)).to(dev)
        if not torch.equal(ipa_fold.ladder_fold(src, base, dig),
                           ipa_fold.ladder_fold_plain(src, base, dig)):
            raise AssertionError(f"fold of {outputs} outputs: K6 differs "
                                 "from its plain version")
        res[f"fold outputs={outputs}"] = {
            "ladder_fold_ms": timed(
                lambda: ipa_fold.ladder_fold(src, base, dig))}
    res.update(fs_times(dev))
    if args.pins:
        res.update(pin_k1(ms, os.path.abspath(args.root)))
    from bulletproof_gadgets_tpu_torch import native
    ptxas = {k: ptxas_usage(native.BUILD_LOG, k) for k in PTXAS_KERNELS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    package = os.path.dirname(os.path.dirname(ms.__file__))
    print(json.dumps({"label": args.label, "package": package,
                      "card": smi[0] if smi else torch.cuda.get_device_name(0),
                      "times": res, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
