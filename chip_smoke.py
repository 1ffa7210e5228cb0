"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. build the CUDA kernels from bulletproof_gadgets_tpu_torch/csrc;
  2. each MSM kernel (K1 bucket accumulation, K3 bucket merge, K4 window
     sums, K5 Horner) against its plain PyTorch version on the card, on the
     example statement's own k=3 commitment MSM and k=1 verifier MSM
     (2^14 gens, 32,770-point table), recorded from one prove + verify of
     it, and K6 (the IPA table-fold ladder) on the same prove's fold
     (16,384 generators folded 16-fold: 2,048 outputs of 16 terms):
     canonical limbs must be equal (tolerance 0), with times;
  3. whole MSMs against the host Pippenger `core.msm.msm_host` at n = 2^10
     (k = 1 and k = 3; random, bit-vector and all-zero vectors, scalars
     >= L);
  4. prove and verify the pinned statements of tests/port_pins.json
     (16-bit BOUND, LESS_THAN, the nine-line example) through
     lang.prove.prove / lang.verify.verify under the pinned seed: proof and
     .coms sha256 equal to the JAX package's, verify true, a tampered proof
     false, warm prove/verify wall times, the device IPA run for every
     device table with one fold per prove of the example, and every kernel
     launched by that run (launch counters reset just before it).
Then the card's name and power limit, one JSON line of per-kernel results
(with each kernel's bound: the larger of its products over the card's
int32 multiply rate and its bytes over the memory rate), and the last line
{"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PINS = os.path.join(ROOT, "tests", "port_pins.json")
MSM_CU = "bulletproof_gadgets_tpu_torch/csrc/msm_kernels.cu"
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "bucket_accumulate": (MSM_CU,
                          "bulletproof_gadgets_tpu/ops/msm_serial.py:852"),
    "bucket_merge": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:979"),
    "window_sums": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:999"),
    "horner": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:921"),
    "ladder_fold": ("bulletproof_gadgets_tpu_torch/csrc/ipa_fold.cu",
                    "bulletproof_gadgets_tpu/ops/ipa_fold.py:170"),
}
# The H100 SXM's rates for the bound: 64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz boost clock, one 32x32->64 product counted per lane and cycle
# (Hopper white paper: 64 INT32 and 128 FP32 lanes per SM; 128 x 2 flops x
# 132 x 1.98 GHz is the data sheet's 67 TFLOP/s fp32); HBM3 at 3.35 TB/s.
INT32_MUL_PER_S = 64 * 132 * 1.98e9
BYTES_PER_S = 3.35e12
PRODUCTS_PER_MUL = 100          # one field mul: 10 x 10 limb products
MULS = {"madd": 7, "padd": 9, "dbl": 8, "padd_cached": 8, "inv": 265}


def say(msg):
    print(msg, flush=True)


def timed(fn, reps):
    """Mean ms per call on the current stream (CUDA events), one warm-up."""
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


def bound(field_muls, tensors):
    """(bound_ms, bound_by): the larger of the field muls' 32x32->64
    products over the int32 multiply rate and the bytes of the given
    tensors (inputs read once, outputs written once) over the memory
    rate."""
    ops_s = field_muls * PRODUCTS_PER_MUL / INT32_MUL_PER_S
    bytes_s = sum(t.numel() * t.element_size() for t in tensors) / BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def compare(name, label, kern, plain, shape, muls, tensors):
    """One kernel against its plain version: equal (tolerance 0), times
    (CUDA events; kernel mean of 5, plain 1, each after a warm-up) and
    bound.  Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    import torch
    t_k, out_k = timed(kern, 5)
    t_p, out_p = timed(plain, 1)
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(out_k, out_p):
        raise AssertionError(f"{name} ({label}): kernel != plain, max abs "
                             f"err {err}")
    b_ms, b_by = bound(muls, list(tensors) + [out_k])
    say(f"kernel {name} [{label}, {shape}]: equal to plain (tolerance 0, "
        f"max abs err {err}); {t_k:.3f} ms vs plain {t_p:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by})")
    return err, t_k, t_p, b_ms, b_by


def check_kernels(ms, src, n, vectors, label):
    """Every MSM kernel against its plain version on one MSM's real inputs.
    Returns {name: (max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    import torch
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    k = len(vectors)
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vectors], axis=1)
    d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
    idx, offs, sub = ms.plan(d.to(src.device), n)
    pool = ms.bucket_accumulate(src, idx)
    buckets = ms.bucket_merge(pool, offs, sub)
    ws = ms.window_sums(buckets)
    # the work these inputs need: live bucket entries (K1), merges of split
    # buckets (K3), running-sum adds up to each window's top bucket (K4)
    entries = int((idx != 2 * n).sum())
    subs = sub.cpu().numpy().astype(np.int64)
    live = (subs > 0).reshape(-1, ms.NB)
    top = np.where(live.any(1), ms.NB - live[:, ::-1].argmax(1), 0)
    stages = {
        "bucket_accumulate": (
            lambda: ms.bucket_accumulate(src, idx),
            lambda: ms.bucket_accumulate_plain(src, idx),
            f"T={idx.shape[0]} P={idx.shape[1]}",
            entries * MULS["madd"], (src, idx)),
        "bucket_merge": (
            lambda: ms.bucket_merge(pool, offs, sub),
            lambda: ms.bucket_merge_plain(pool, offs, sub),
            f"M={offs.shape[0]} max_sub={int(subs.max())}",
            int(np.maximum(subs - 1, 0).sum()) * MULS["padd"],
            (pool, offs, sub)),
        "window_sums": (
            lambda: ms.window_sums(buckets),
            lambda: ms.window_sums_plain(buckets),
            f"windows={ws.shape[2]}",
            int(live.sum() + top.sum()) * MULS["padd"], (buckets,)),
        "horner": (
            lambda: ms.horner(ws, k), lambda: ms.horner_plain(ws, k),
            f"k={k}",
            k * (ms.W - 1) * (ms.C * MULS["dbl"] + MULS["padd"]), (ws,)),
    }
    return {name: compare(name, label, *st) for name, st in stages.items()}


def check_fold(ipa_fold, src, base, dig):
    """K6 against its plain version on one fold's real inputs."""
    k, n = base.shape
    muls = (n * k * (3 * MULS["madd"] + 4 * MULS["dbl"] + 7)  # multiples
            + n * 63 * 4 * MULS["dbl"]                # doublings after w=63
            + int((dig != 8).sum()) * MULS["padd_cached"]  # digits != 0
            + n * (MULS["inv"] + 4))                  # Z inversion, affine
    return compare("ladder_fold", "example fold",
                   lambda: ipa_fold.ladder_fold(src, base, dig),
                   lambda: ipa_fold.ladder_fold_plain(src, base, dig),
                   f"K={k} outputs={n}", muls, (src, base, dig))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bulletproof_gadgets_tpu_torch import native
    from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
    from bulletproof_gadgets_tpu_torch.core.msm import msm_host
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.ops import (
        engine, ipa_fold, ipa_fused, msm_serial as ms)
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng

    with open(PINS) as f:
        pins = json.load(f)
    device = engine.register("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # 1. build
    t0 = time.time()
    path = native.build()
    native.load()
    say(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s "
        f"for {smi}")
    for line in native.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            say(f"  ptxas: {line.strip()}")

    # 2. kernels against their plain versions on the example's own MSMs
    #    and its fold
    ex = pins["statements"]["example"]
    calls, folds = [], []
    table_msm_many = ms.GeneratorTable.msm_many
    ladder_fold = ipa_fold.ladder_fold

    def record(table, vectors):
        calls.append((table, [list(v) for v in vectors]))
        return table_msm_many(table, vectors)

    def record_fold(src, base, dig):
        folds.append((src, base, dig))
        return ladder_fold(src, base, dig)

    t0 = time.time()
    ms.GeneratorTable.msm_many = record
    ipa_fold.ladder_fold = record_fold
    try:
        blind_rng.set_seed(pins["seed"])
        coms = []
        proof, _ = prove("example", ex["instance"], ex["witness"],
                         ex["gadgets"], coms)
        ok = verify("example", ex["instance"], proof, "".join(coms),
                    ex["gadgets"])
    finally:
        ms.GeneratorTable.msm_many = table_msm_many
        ipa_fold.ladder_fold = ladder_fold
        blind_rng.set_seed(None)
    (t_commit, v_commit), (t_ver, v_ver) = calls[0], calls[-1]
    if not ok or len(v_commit) != 3 or len(v_ver) != 1 or len(folds) != 1:
        raise AssertionError(f"example: verify {ok}, first/last table MSM "
                             f"k={len(v_commit)}/{len(v_ver)}, want 3/1, "
                             f"{len(folds)} folds, want 1")
    say(f"example: {len(calls)} table MSMs ({t_commit.m} points on "
        f"{device}) and one fold recorded from one prove + verify in "
        f"{time.time() - t0:.1f} s")
    results = check_kernels(ms, t_commit.src, t_commit.m, v_commit,
                            "k=3 commitment launch")
    check_kernels(ms, t_ver.src, t_ver.m, v_ver, "k=1 verifier launch")
    results["ladder_fold"] = check_fold(ipa_fold, *folds[0])

    # 3. whole MSMs against the host Pippenger
    pts = list(BulletproofGens(1024).G(1024))
    src = torch.from_numpy(ms.prep_source(pts)).to(device)
    r = random.Random(3)
    cases = {"k=1 random": [[r.randrange(L) for _ in range(1024)]],
             "k=3 bits/zeros/>=L": [[r.randrange(2) for _ in range(1024)],
                                    [0] * 1024,
                                    [r.randrange(L, 4 * L)
                                     for _ in range(1024)]]}
    for label, vecs in cases.items():
        got = ms.msm_many(vecs, src, len(pts))
        want = [msm_host(v, pts) for v in vecs]
        if [g.compress() for g in got] != [w.compress() for w in want]:
            raise AssertionError(f"MSM n=1024 {label}: differs from msm_host")
        say(f"msm n=1024 {label}: equal to msm_host")

    # 4. the main path: prove and verify the pinned statements
    ipa_runs = []                                # [n, folds] per argument
    fused_create, materialize = ipa_fused.create, ipa_fold.materialize

    def count_ipa(transcript, table, w, G_factors, *a, **kw):
        ipa_runs.append([len(G_factors), 0])
        return fused_create(transcript, table, w, G_factors, *a, **kw)

    def count_fold(*a):
        ipa_runs[-1][1] += 1
        return materialize(*a)
    ipa_fused.create, ipa_fold.materialize = count_ipa, count_fold
    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    for name in ("bound16", "less_than", "example"):
        st = pins["statements"][name]
        times = []
        for _ in range(2):                       # first, then warm
            blind_rng.set_seed(pins["seed"])
            coms = []
            del ipa_runs[:]
            t0 = time.time()
            proof, _ = prove(name, st["instance"], st["witness"],
                             st["gadgets"], coms)
            t_prove = time.time() - t0
            device_ipa = 2 * st["gens"] + 2 >= engine.MIN_DEVICE_MSM
            want = [[st["gens"], int(name == "example")]] if device_ipa else []
            if ipa_runs != want:
                raise AssertionError(f"{name}: device IPA runs [n, folds] "
                                     f"{ipa_runs}, want {want}")
            coms = "".join(coms)
            if (hashlib.sha256(proof).hexdigest() != st["proof_sha256"]
                    or hashlib.sha256(coms.encode()).hexdigest()
                    != st["coms_sha256"]):
                raise AssertionError(f"{name}: proof or .coms differ from "
                                     "the JAX package's pin")
            t0 = time.time()
            ok = verify(name, st["instance"], proof, coms, st["gadgets"])
            t_verify = time.time() - t0
            if not ok:
                raise AssertionError(f"{name}: verify returned false")
            times.append((t_prove, t_verify))
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        if verify(name, st["instance"], bytes(bad), coms, st["gadgets"]):
            raise AssertionError(f"{name}: tampered proof verified")
        blind_rng.set_seed(None)
        say(f"statement {name} ({st['multipliers']} multipliers, "
            f"{st['gens']} gens): proof and .coms equal the pins, verify "
            f"true, tampered false, device IPA runs [n, folds] {ipa_runs}; "
            f"prove first {times[0][0]:.2f} s warm {times[1][0]:.2f} s, "
            f"verify first {times[0][1]:.2f} s warm {times[1][1]:.2f} s")
    launches = dict(ms.LAUNCHES)
    ipa_fused.create, ipa_fold.materialize = fused_create, materialize
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the main path: {idle}")
    say(f"main path launches: {launches}")

    say(smi)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_file,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": results[name][0], "ms": results[name][1],
         "plain_ms": results[name][2], "bound_ms": results[name][3],
         "bound_by": results[name][4], "library_ms": None}
        for name, (src_file, replaces) in KERNELS.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
