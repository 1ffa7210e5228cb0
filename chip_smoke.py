"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):
  1. build the CUDA kernels from bulletproof_gadgets_tpu_torch/csrc;
  2. each kernel (K1 bucket accumulation, K3 bucket merge, K4 window sums,
     K5 Horner) against its plain PyTorch version on the card, on the
     example statement's own k=3 commitment MSM and k=1 verifier MSM
     (2^14 gens, 32,770-point table), recorded from one prove + verify of
     it: canonical limbs must be equal (tolerance 0), with times;
  3. whole MSMs against the host Pippenger `core.msm.msm_host` at n = 2^10
     (k = 1 and k = 3; random, bit-vector and all-zero vectors, scalars
     >= L);
  4. prove and verify the pinned statements of tests/port_pins.json
     (16-bit BOUND, LESS_THAN, the nine-line example) through
     lang.prove.prove / lang.verify.verify under the pinned seed: proof and
     .coms sha256 equal to the JAX package's, verify true, a tampered proof
     false, warm prove/verify wall times, and every kernel launched by that
     run (launch counters reset just before it).
Then the card's name and power limit, one JSON line of per-kernel results,
and the last line {"ok": true, "device": {...}}.
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
SOURCE = "bulletproof_gadgets_tpu_torch/csrc/msm_kernels.cu"
REPLACES = {
    "bucket_accumulate": "bulletproof_gadgets_tpu/ops/msm_serial.py:852",
    "bucket_merge": "bulletproof_gadgets_tpu/ops/msm_serial.py:979",
    "window_sums": "bulletproof_gadgets_tpu/ops/msm_serial.py:999",
    "horner": "bulletproof_gadgets_tpu/ops/msm_serial.py:921",
}


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


def check_kernels(ms, fp, src, n, vectors, label):
    """Every kernel against its plain version on one MSM's real inputs.
    Returns {name: (max_abs_err, ms, plain_ms, shape)}."""
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
    stages = {
        "bucket_accumulate": (lambda: ms.bucket_accumulate(src, idx),
                              lambda: ms.bucket_accumulate_plain(src, idx),
                              f"T={idx.shape[0]} P={idx.shape[1]}"),
        "bucket_merge": (lambda: ms.bucket_merge(pool, offs, sub),
                         lambda: ms.bucket_merge_plain(pool, offs, sub),
                         f"M={offs.shape[0]} max_sub={int(sub.max())}"),
        "window_sums": (lambda: ms.window_sums(buckets),
                        lambda: ms.window_sums_plain(buckets),
                        f"windows={ws.shape[2]}"),
        "horner": (lambda: ms.horner(ws, k), lambda: ms.horner_plain(ws, k),
                   f"k={k}"),
    }
    res = {}
    for name, (kern, plain, shape) in stages.items():
        t_k, out_k = timed(kern, 5)
        t_p, out_p = timed(plain, 1)
        ck = fp.canonical(out_k.to(torch.int64).transpose(0, 1))
        cp = fp.canonical(out_p.to(torch.int64).transpose(0, 1))
        err = int((ck - cp).abs().max())
        if err != 0 or not torch.equal(out_k, out_p):
            raise AssertionError(f"{name} ({label}): kernel != plain, "
                                 f"max abs err {err}")
        res[name] = (err, t_k, t_p, shape)
        say(f"kernel {name} [{label}, {shape}]: equal to plain (tolerance "
            f"0, max abs err {err}); {t_k:.3f} ms vs plain {t_p:.3f} ms")
    return res


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
    from bulletproof_gadgets_tpu_torch.ops import engine, fp, msm_serial as ms
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
    ex = pins["statements"]["example"]
    calls = []
    table_msm_many = ms.GeneratorTable.msm_many

    def record(table, vectors):
        calls.append((table, [list(v) for v in vectors]))
        return table_msm_many(table, vectors)

    t0 = time.time()
    ms.GeneratorTable.msm_many = record
    try:
        blind_rng.set_seed(pins["seed"])
        coms = []
        proof, _ = prove("example", ex["instance"], ex["witness"],
                         ex["gadgets"], coms)
        ok = verify("example", ex["instance"], proof, "".join(coms),
                    ex["gadgets"])
    finally:
        ms.GeneratorTable.msm_many = table_msm_many
        blind_rng.set_seed(None)
    (t_commit, v_commit), (t_ver, v_ver) = calls[0], calls[-1]
    if not ok or len(v_commit) != 3 or len(v_ver) != 1:
        raise AssertionError(f"example: verify {ok}, first/last table MSM "
                             f"k={len(v_commit)}/{len(v_ver)}, want 3/1")
    say(f"example: {len(calls)} table MSMs ({t_commit.m} points on "
        f"{device}) recorded from one prove + verify in "
        f"{time.time() - t0:.1f} s")
    commit = check_kernels(ms, fp, t_commit.src, t_commit.m, v_commit,
                           "k=3 commitment launch")
    check_kernels(ms, fp, t_ver.src, t_ver.m, v_ver, "k=1 verifier launch")

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
    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    for name in ("bound16", "less_than", "example"):
        st = pins["statements"][name]
        times = []
        for _ in range(2):                       # first, then warm
            blind_rng.set_seed(pins["seed"])
            coms = []
            t0 = time.time()
            proof, _ = prove(name, st["instance"], st["witness"],
                             st["gadgets"], coms)
            t_prove = time.time() - t0
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
            f"true, tampered false; prove first {times[0][0]:.2f} s warm "
            f"{times[1][0]:.2f} s, verify first {times[0][1]:.2f} s warm "
            f"{times[1][1]:.2f} s")
    launches = dict(ms.LAUNCHES)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels not launched by the main path: {idle}")
    say(f"main path launches: {launches}")

    say(smi)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": commit[name][0], "ms": commit[name][1],
         "plain_ms": commit[name][2]} for name in REPLACES]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
