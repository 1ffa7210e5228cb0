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
     canonical limbs must be equal (tolerance 0), with times; K1, K2, K8,
     K9 and K10 also on crafted rows and carried pools whose coordinates
     sit at the edges of their radix-2^32 core (EDGE_VALUES) and on 2^16
     seeded random lanes x 8 rounds, each against its plain version and
     K8/K10 against K1 (K9 against K2); every kernel's registers and
     spills from the build, and K3's, K4's and K5's times as multiples of
     K1's on the same launch (K3, K4 and K5 are held against their plain
     versions at k = 9 too, after phase 6 has recorded the stacked
     merkle32 x 3 launch);
  3. whole MSMs against the host Pippenger `core.msm.msm_host` at n = 2^10
     (k = 1 and k = 3; random, bit-vector and all-zero vectors, scalars
     >= L; the k = 3 case also in point chunks of 256; k = 2 on digits
     that concentrate in one bucket per window: one scalar repeated, all
     ones), each schedule's pool at or under its bound P;
  4. the main path: prove and verify the pinned statements of
     tests/port_pins.json (16-bit BOUND, LESS_THAN, the nine-line example,
     and merkle32: a depth-5 MiMC Merkle membership, 2^16 gens, a
     131,074-point table in two point chunks) through lang.prove.prove /
     lang.verify.verify under the pinned seed, once first and once warm:
     proof and .coms sha256 equal to the JAX package's, verify true, a
     tampered proof false, wall times, the device IPA run for every device
     table with its folds, the chunked table MSMs counted (one K7 launch
     each), the host flattening / exp_iter / digit recode never called for
     example and merkle32, and every kernel launched by that run (launch
     counters reset just before it, read just after), the commitments'
     compression and the IPA's transcript included; the warm merkle32
     argument (ipa_fused.create) under torch.cuda's sync debug mode: no
     synchronizing call in its round loop (its MSMs' schedules are built
     on the device), its one readback at the end;
  5. K7 (point_sum, the chunk combine) against its plain version on
     merkle32's own chunk window sums recorded from that run, on one wide
     launch (2^17 lanes of real points) and on merkle32's commitment MSM
     in 17 point chunks of 2^13 (one K7 launch, encodings equal to the
     unchunked MSM's); the time of a launch that does almost nothing;
     K1's time per entry on merkle32's commitment MSM with and without
     point chunks; K6 against its plain version on merkle32's fold
     recorded from that run (65,536 generators folded 16-fold: 8,192
     outputs of 16 terms), with times;
  6. the batch path (lang.batch.prove_batch / verify_batch, launch counters
     reset just before it and read just after): the two batch pins of
     tests/port_pins.json (three 16-bit BOUND witnesses on a host table
     and on a device table) byte-equal; example x 3 and merkle32 x 3
     (three copies of the pinned witness, differing by their blindings)
     stacked (first, with the device hashing of the MiMC images; and warm)
     and with max_k=3, byte-equal to each other, all verifying, a
     tampered proof rejected; merkle32's stacked k = 9 commitment MSM
     over its 2^17-point chunk runs round chunks, so K2 must launch;
  7. K2 against its plain version on one round chunk of that MSM; K1 + K2
     round-chunked against one unchunked K1 on the same digits (kernels
     alone, and the whole MSM with its peak memory);
  8. warm ms per witness of a batch of 8 64-bit BOUND witnesses against 8
     sequential proves;
  9. the pre-transposed layouts of the bucket accumulation (cols: the
     gather_cols pass, then K8, and K9 past the slot budget; flat: the
     gather_flat pass, then K10): (a) K8 and K10 against their plain
     versions and K1's pool on the example's k=3 commitment launch, K9
     against its plain version and K2 on the merkle32 x 3 round chunk
     (tolerance 0); (b) on the example's k=3 launch, merkle32's k=3
     commitment chunk (2^17 points) and that round chunk, K1 (K2) against
     gather + K8 (K9) and gather + K10, each with its gather's time and its
     peak memory above the inputs, then the whole msm_digits_t of the three
     MSMs under each layout; (c) the main path under
     engine.register("cuda", msm_layout=...) for cols and for flat: the four
     pinned statements (first and warm, verify true, tampered false) and
     merkle32 x 3 stacked byte-equal to the rows batch of phase 6 and
     verifying, with the launch counters reset before each layout's run and
     read after it (cols must launch K8 and K9 and no K1/K2; flat K10 and
     no K1/K2/K8/K9);
 10. the device transcript's kernels (ristretto_compress: MSM points to
     RFC 9496 bytes; transcript_round: an IPA round's Merlin absorbs,
     challenge and F_l inversion) against their plain versions (tolerance
     0) on merkle32's warm prove recorded in phase 4 and on edge inputs
     (the identity and random points with carried limbs, also against the
     host's bytes; transcripts at eight byte positions over four rounds;
     64 chosen challenge strings), with times and bounds; both are one
     thread's chain, so each also gets a latency bound: its chain of
     dependent field products times one product's latency, measured by a
     probe on one thread;
 11. the embedding surfaces on the card: (a) the HTTP proof service
     (cli/serve.Handler on a ThreadingHTTPServer in this process): /prove
     and /verify of example, merkle32 and the flat and nested OR pins,
     first and warm, byte-equal to the pins, verify true, tampered false,
     per-request wall times beside phase 4's direct ones, the launch
     counters reset just before the requests and read just after (K1,
     K3-K7, the compression and the transcript round must launch); (b) the
     C ABI (capi/bpg_ffi.c) loaded into this process: c_prove / c_verify of
     example; (c) the same ABI embedded in a C program (capi/bpg_embed.c)
     run as a fresh process on CUDA; (d) the JNI layer (capi/bpg_jni.c)
     through a JNIEnv made in Python (capi/jni_host); each the pinned
     bytes, 1 and 0 for a tampered proof; (e) warm merkle32 proved and
     verified with the C transcript and with the Python one in alternating
     pairs (bytes equal to the pin), host seconds per prove and verify,
     and one IPA round's absorbs and challenge on each;
 12. the 2^20-gens stress circuit (scripts/run_stress_512_torch.run in
     this process): its 4-leaf pin (merkle_tree4 of tests/port_pins.json)
     byte-equal, then 512 leaves on `rows` (scripts/profile_stress.
     stress_record): 1,986,769 constraints and 993,384 multipliers (the
     JAX package's record), verify true, a tampered copy false, each
     step's seconds, host peak RSS and device peak memory, launches per
     kernel (counters reset just before its prove, read after its verify),
     the commitments' k = 3 and the verifier's k = 1 table MSMs (17 point
     chunks) under rows and cols, K1 per entry on a 2^17-point chunk of
     this table (past the L2) beside merkle32's (within it), the host's
     CPU count and the generator map's seconds, the device map held
     against the host's first 4,096 generators; then the stress path's
     own kernel inputs against the plain versions (tolerance 0): K1, K3,
     K4 and K5 on the first 2^17-point chunk of the commitments' and the
     verifier's table MSMs, K6 on its first fold (131,072 outputs), K7 on
     its first chunk combine (D = 17); it fails if K2 launched there;
 13. the sharded path (parallel/) over torch.distributed on the one card:
     (a) two ranks over gloo (bulletproof_gadgets_tpu_torch.parallel.
     distributed.run_ranks), both on cuda:0 with their window sums and
     collectives through the host, a mesh active, example and merkle32
     proved (first and warm, pinned seed) and verified through lang.prove
     / lang.verify on every rank: proof and .coms equal the pins, verify
     true, a tampered copy false, the launch counters reset before each
     statement and read after it (K1, K3, K4, K5, K7 and the compression
     must launch on every rank, K6 and the transcript round must not: the
     sharded argument folds scalars and keeps the host transcript), K7 on
     the two ranks' example commitment window sums against its plain
     version, per-rank wall times beside phase 4's one-device ones; (b)
     four ranks on example, the same checks; (c) NCCL at world size one:
     the mesh collectives on CUDA tensors, a ShardedGeneratorTable at D = 1
     whose example commitment encodings equal GeneratorTable's, K7 on its
     gathered window sums against its plain version.  A rank that fails
     fails the phase.
Every phase prints its seconds.  Then the card's name and power limit, one
JSON line of per-kernel results (with each kernel's bound: the larger of
its products, PRODUCTS_PER_MUL a field mul (the two one-thread kernels:
their word products, a squaring at its distinct pairs), over the card's
int32 multiply rate and its bytes over the memory rate, where the bucket
accumulations count only the entries before each lane's stop;
launches are the single-proof path's, the batch
path's, the two layout runs', phase 11's requests, phase 12's stress
run and phase 13's ranks together), and the last line {"ok": true, "device": {...}}.
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
    "bucket_accumulate_cont": (
        MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:881"),
    "bucket_merge": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:979"),
    "window_sums": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:999"),
    "horner": (MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:921"),
    "ladder_fold": ("bulletproof_gadgets_tpu_torch/csrc/ipa_fold.cu",
                    "bulletproof_gadgets_tpu/ops/ipa_fold.py:170"),
    "point_sum": (MSM_CU, "bulletproof_gadgets_tpu/ops/pallas_curve.py:178"),
    "bucket_accumulate_cols": (
        MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:801"),
    "bucket_accumulate_cols_cont": (
        MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:828"),
    "bucket_accumulate_flat": (
        MSM_CU, "bulletproof_gadgets_tpu/ops/msm_serial.py:901"),
    # no Pallas kernel: the JAX package runs these as jnp under jit
    "ristretto_compress": (
        "bulletproof_gadgets_tpu_torch/csrc/ristretto.cu",
        "bulletproof_gadgets_tpu/ops/ristretto_device.py:173"),
    "transcript_round": (
        "bulletproof_gadgets_tpu_torch/csrc/transcript.cu",
        "bulletproof_gadgets_tpu/ops/ipa_fused.py:122"),
}
# the bucket-accumulation kernels of each layout (ops/msm_serial.LAYOUTS)
LAYOUT_KERNELS = {
    "rows": ("bucket_accumulate", "bucket_accumulate_cont"),
    "cols": ("bucket_accumulate_cols", "bucket_accumulate_cols_cont"),
    "flat": ("bucket_accumulate_flat",)}
OTHER_LAYOUTS = LAYOUT_KERNELS["cols"] + LAYOUT_KERNELS["flat"]
# device IPA runs [n, folds] per prove of a statement on a device table
IPA_RUNS = {"bound16": [], "less_than": [[512, 0]], "example": [[16384, 1]],
            "merkle32": [[65536, 1]]}
# The H100 SXM's rates for the bound: 64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz boost clock, one 32x32->64 product counted per lane and cycle
# (Hopper white paper: 64 INT32 and 128 FP32 lanes per SM; 128 x 2 flops x
# 132 x 1.98 GHz is the data sheet's 67 TFLOP/s fp32); HBM3 at 3.35 TB/s.
INT32_MUL_PER_S = 64 * 132 * 1.98e9
BYTES_PER_S = 3.35e12
# the cheapest field product in the package: csrc/field32.cuh's fe8_mul,
# 8 x 8 word products and 16 for the fold of the high half x 38 (field.cuh's
# 10-limb fe_mul forms 10 x 10; its bound is printed beside for comparison)
PRODUCTS_PER_MUL = 80
PRODUCTS_PER_MUL_10LIMB = 100
MULS = {"madd": 7, "padd": 9, "dbl": 8, "padd_cached": 8, "inv": 265}
# The one-thread kernels' work in word products, a squaring counted at the
# 36 distinct pairs of its 8 x 8 square: F_p (fe8) squaring 36 + 16 (the
# fold) and product 64 + 16; F_l (fl8, Montgomery) product 64 + 48 (m =
# t0 l' and m * l's 5 non-zero words of l, 8 times).
# ristretto_compress, per point: 255 squarings (251 in z^((p-5)/8)) and 29
# products (SQRT_RATIO_M1 at u = 1 forms no product by u); one dependent
# chain of 255 squarings (fe8_sqr) and 23 products (fe8_mul).
# transcript_round, per transcript: 5 fl8 products (2 for the wide
# reduction, 2 conversions to ops/fl rows, 1 back to Montgomery form after
# the inversion) and the divsteps inversion's word products, which depend
# on u (fl_inversion_products); one chain of the duplex's one or two
# f1600 (~5k 32-bit logic ops each, on the ALU pipe, left out of the
# operations bound), one product, the inversion with its product, and one
# product.
COMPRESS_WORD_PRODUCTS = 255 * (36 + 16) + 29 * (64 + 16)
COMPRESS_CHAIN_SQR, COMPRESS_CHAIN_MUL = 255, 23
TRANSCRIPT_FL8_PRODUCTS = 5
FL8_WORD_PRODUCTS = 64 + 48
ROUND_ABSORBED = 91     # bytes a round absorbs before its challenge
FIELD_L = 2**252 + 27742317777372353535851937790883648493
# challenge strings (64 bytes, little-endian) at the F_l part's edges: 0,
# values around l, 2^252, 2^256 and 2^512
CHALLENGE_EDGES = (0, 1, FIELD_L - 1, FIELD_L, FIELD_L + 1, 1 << 252,
                   (1 << 256) - 1, 1 << 256, FIELD_L << 256,
                   (1 << 512) - 1, (1 << 512) - FIELD_L)
POINT_CHUNK_D17 = 1 << 13       # merkle32's 131,074-point table: 17 chunks
BOUND64_BATCH = 8               # witnesses of phase 8's batch


# field values at the edges of the bucket accumulation's radix-2^32 core
# (csrc/field32.cuh): words all ones or all zeros, the wrap of 2^256 = 38
FIELD_P = 2**255 - 19
EDGE_VALUES = (0, 1, 19, 38, FIELD_P - 1, FIELD_P - 38, 2**224 - 1,
               2**254 - 1, 2**254 + 1, 2**32 - 1)


def say(msg):
    print(msg, flush=True)


SLEEP_CYCLES = 20_000_000   # ~10 ms of device time at 1.98 GHz


def timed(fn, reps):
    """Mean ms per call on the current stream (CUDA events), one warm-up.
    The launches are queued behind a device sleep of SLEEP_CYCLES, so the
    events time the card and not the host's launch rate (a one-thread
    kernel takes less time than its wrapper's Python)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(field_muls, tensors, products=PRODUCTS_PER_MUL):
    """(bound_ms, bound_by): the larger of the field muls' 32x32->64
    products over the int32 multiply rate and the bytes of the given
    tensors (inputs read once, outputs written once; an int is a byte
    count) over the memory rate."""
    ops_s = field_muls * products / INT32_MUL_PER_S
    bytes_s = sum(t if isinstance(t, int) else t.numel() * t.element_size()
                  for t in tensors) / BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def accumulation_bytes(ms, idx, ident, src=None):
    """The bytes a bucket accumulation must read on idx int32 [T, P] (K1,
    K2: with their source rows src; K8-K10: gathered coordinates), where
    each lane stops at its first slot of row `ident`: per live entry its
    x | y | t2d (3*NL int32), and with src its idx word and each distinct
    row once (ROW int32) instead; one 4-byte mark (idx word or x limb 0)
    per lane that stops before its last round.  The pools read and written
    are counted by the caller."""
    live = idx != ident
    entries = int(live.sum())
    stops = int((~live).any(0).sum())
    if src is None:
        return entries * 3 * ms.NL * 4 + stops * 4
    rows = int(idx[live].unique().numel())
    return rows * src.shape[1] * 4 + (entries + stops) * 4


def compare(name, label, kern, plain, shape, muls, tensors,
            chain_ms=None):
    """One kernel against its plain version: equal (tolerance 0), times
    (CUDA events; kernel mean of 5, plain 1, each after a warm-up) and
    bound.  With chain_ms (a one-thread kernel: muls are then word
    products, and chain_ms its dependent chain's latency) that latency is
    printed beside the bound.  Returns (max_abs_err, ms, plain_ms,
    bound_ms, bound_by)."""
    import torch
    t_k, out_k = timed(kern, 5)
    t_p, out_p = timed(plain, 1)
    outs = list(out_k) if isinstance(out_k, tuple) else [out_k]
    if isinstance(out_k, tuple):                 # compared as one vector
        out_k, out_p = (torch.cat([t.flatten().to(torch.int64) for t in o])
                        for o in (out_k, out_p))
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(out_k, out_p):
        raise AssertionError(f"{name} ({label}): kernel != plain, max abs "
                             f"err {err}")
    if chain_ms is None:
        b_ms, b_by = bound(muls, list(tensors) + outs)
        b10_ms, b10_by = bound(muls, list(tensors) + outs,
                               PRODUCTS_PER_MUL_10LIMB)
        beside = f"at 100 products per mul {b10_ms:.4g} ms, {b10_by}"
    else:
        b_ms, b_by = bound(muls, list(tensors) + outs, 1)
        beside = f"latency bound {chain_ms:.4g} ms"
    say(f"kernel {name} [{label}, {shape}]: equal to plain (tolerance 0, "
        f"max abs err {err}); {t_k:.3f} ms vs plain {t_p:.3f} ms; bound "
        f"{b_ms:.4g} ms ({b_by}; {beside})")
    return err, t_k, t_p, b_ms, b_by


def product_latency(device, n=4096):
    """ms of one link of the one-thread kernels' chains on one thread:
    fe8_mul and fe8_sqr (the compression's), fl8_mont_mul, the divsteps
    inversion fl8_inv_mont and Keccak-f[1600] (the transcript's), from
    probes running n dependent links and one (CUDA events, mean of 5 each).
    The inversion's time depends on its input: its probe inverts n values
    (x + 1, then its inverse + 1, ...)."""
    import torch
    from bulletproof_gadgets_tpu_torch import native
    lib = native.load()
    x = torch.from_numpy(np.array(            # < 2^252 < l
        [0x1234567, 0x89abcdef, 0x2468ace, 0x13579bdf, 0xfedcba9,
         0x76543210, 0xdeadbeef, 0x0abcdef0], dtype=np.uint32).view(
             np.int32)).to(device)
    lanes = torch.from_numpy(np.random.default_rng(1600).integers(
        0, 256, 200, dtype=np.uint8)).to(device)
    lat = {}
    for name, fn, arg in (("fe8_mul", lib.bpg_fe8_mul_chain, x),
                          ("fe8_sqr", lib.bpg_fe8_sqr_chain, x),
                          ("fl8_mont_mul", lib.bpg_fl8_mul_chain, x),
                          ("fl8_inv", lib.bpg_fl8_inv_chain, x),
                          ("f1600", lib.bpg_f1600_chain, lanes)):
        out = torch.empty_like(arg)

        def run(m, fn=fn, arg=arg, out=out, name=name):
            rc = fn(arg.data_ptr(), m, out.data_ptr(), native.stream(arg))
            if rc:
                raise RuntimeError(f"{name} probe: cudaError {rc}")
        lat[name] = (timed(lambda: run(n), 5)[0]
                     - timed(lambda: run(1), 5)[0]) / (n - 1)
    say("one dependent link on one thread: " + ", ".join(
        f"{k} {1e6 * v:.1f} ns" for k, v in lat.items())
        + f" (latency probes, {n} links less one)")
    return lat


def fl_inversion_products(x):
    """The 32 x 32 -> 64 products that csrc/field_l.cuh fl8_inv forms on x
    (< l), from a mirror of its loop on Python ints: per batch of 30
    divsteps 99 (update_de 2 x 9 x 3 + 2, update_fg 2 x 9 x 2, f's inverse
    mod 2^32 7), per inner step 4 (w and its three updates), per swap 7
    (the new f's inverse)."""
    m32, m30 = (1 << 32) - 1, (1 << 30) - 1
    f, g, eta, total = FIELD_L, x, -1, 0
    while True:
        u, v, q, r, fw, gw, i = 1, 0, 0, 1, f & m30, g & m30, 30
        total += 99
        while True:
            zeros = ((gw | (m32 << i & m32)) & -(gw | (m32 << i & m32))
                     ).bit_length() - 1
            gw >>= zeros
            u, v = u << zeros & m32, v << zeros & m32
            eta, i = eta - zeros, i - zeros
            if i == 0:
                break
            if eta < 0:
                eta = -eta
                fw, gw = gw, -fw & m32
                u, q = q, -u & m32
                v, r = r, -v & m32
                total += 7
            limit = min(eta + 1, i)
            w = (-gw * pow(fw, -1, 1 << 32)) & ((1 << limit) - 1)
            gw = (gw + fw * w) & m32
            q, r = (q + u * w) & m32, (r + v * w) & m32
            total += 4
        sgn = [c - (1 << 32) if c >> 31 else c for c in (u, v, q, r)]
        f, g = ((sgn[0] * f + sgn[1] * g) >> 30,
                (sgn[2] * f + sgn[3] * g) >> 30)
        if g == 0:
            return total


def check_kernels(ms, digits, src, n, label, only=None):
    """Every MSM kernel (or those named in `only`) against its plain
    version on one MSM's real inputs (its device digits [k*W, n] over the
    source rows).  Returns {name: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by)}."""
    k = digits.shape[0] // ms.W
    idx, offs, sub = ms.plan(digits, n)
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
            entries * MULS["madd"],
            (accumulation_bytes(ms, idx, 2 * n, src),)),
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
    return {name: compare(name, label, *st) for name, st in stages.items()
            if only is None or name in only}


def edge_inputs(device, lanes=None, rounds=8, seed=0):
    """Crafted inputs of the bucket accumulation (K1, K2, K8-K10): (src
    int32 [S, ROW], idx int32 [rounds, P], acc int32 [4, NL, P]).  The rows'
    x, y, t2d need not be curve points (the adds are the same field
    arithmetic either way).  lanes None: every (x, y, t2d) in EDGE_VALUES^3
    as a row (1,000 rows), lane p's round t reading row (p + 337 t) mod
    1,000, and the pool's coordinates edge values (lane p: the digits of
    p, and 7p, in base 10); else `lanes` lanes over 4,096 rows, rows, pool
    limbs and idx uniform from the seed (limb i in [0, 2^w))."""
    import torch
    from bulletproof_gadgets_tpu_torch.ops import fp
    nl = fp.NL
    if lanes is None:
        e = EDGE_VALUES
        trip = [(x, y, t) for x in e for y in e for t in e]
        cols = [fp.ints_to_limbs([v[c] for v in trip]) for c in range(3)]
        p = len(trip)
        lane = np.arange(p)
        idx = (lane[None, :] + 337 * np.arange(rounds)[:, None]) % p
        digits = [lane % 10, lane // 10 % 10, lane // 100 % 10, 7 * lane % 10]
        acc = np.stack([fp.ints_to_limbs([e[d] for d in dig])
                        for dig in digits])
    else:
        rng = np.random.default_rng(seed)
        widths = np.array(fp.W)[:, None]

        def limbs(n):
            return (rng.integers(0, 1 << 26, (nl, n)) % (1 << widths)
                    ).astype(np.int32)
        p, n_rows = lanes, 4096
        cols = [limbs(n_rows) for _ in range(3)]
        idx = rng.integers(0, n_rows, (rounds, p))
        acc = np.stack([limbs(p) for _ in range(4)])
    rows = np.zeros((cols[0].shape[1], 32), dtype=np.int32)
    rows[:, :3 * nl] = np.concatenate(cols).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(device) for a in (rows, idx, acc))


def check_edge_kernels(ms, device):
    """Phase 2: K1, K2, K8, K9 and K10 against their plain versions
    (tolerance 0) on edge_inputs (the core's edge values; 2^16 seeded
    random lanes x 8 rounds); K8's and K10's pools against K1's, K9's
    against K2's."""
    import torch
    for label, lanes in (("edge values", None),
                         ("random, 2^16 lanes", 1 << 16)):
        src, idx, acc = edge_inputs(device, lanes)
        t, p = idx.shape
        g_cols, g_flat = ms.gather_cols(src, idx), ms.gather_flat(src, idx)
        runs = {
            "bucket_accumulate": (
                ms.bucket_accumulate(src, idx),
                ms.bucket_accumulate_plain(src, idx)),
            "bucket_accumulate_cont": (
                ms.bucket_accumulate_cont(src, idx, acc),
                ms.bucket_accumulate_cont_plain(src, idx, acc)),
            "bucket_accumulate_cols": (
                ms.bucket_accumulate_cols(g_cols),
                ms.bucket_accumulate_cols_plain(g_cols)),
            "bucket_accumulate_cols_cont": (
                ms.bucket_accumulate_cols_cont(g_cols, acc),
                ms.bucket_accumulate_cols_cont_plain(g_cols, acc)),
            "bucket_accumulate_flat": (
                ms.bucket_accumulate_flat(g_flat, t, p),
                ms.bucket_accumulate_flat_plain(g_flat, t, p))}
        bad = [name for name, (k, pl) in runs.items()
               if not torch.equal(k, pl)]
        k1 = runs["bucket_accumulate"][0]
        k2 = runs["bucket_accumulate_cont"][0]
        if (bad or not torch.equal(runs["bucket_accumulate_cols"][0], k1)
                or not torch.equal(runs["bucket_accumulate_flat"][0], k1)
                or not torch.equal(runs["bucket_accumulate_cols_cont"][0],
                                   k2)):
            raise AssertionError(f"field edges ({label}): kernels != plain "
                                 f"{bad}, or K8/K10 != K1, K9 != K2")
        say(f"field edges ({label}, T={t} P={p}): K1, K2, K8, K9, K10 equal "
            "to plain (tolerance 0); K8, K10 equal K1; K9 equals K2")


def ptxas_usage(log, kernel):
    """The registers and spills that ptxas (-Xptxas -v) reports for the
    kernel whose mangled name contains `kernel`."""
    lines, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = kernel in line
        elif mine and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines) or "not in the build log"


def check_fold(ipa_fold, src, base, dig, label):
    """K6 against its plain version on one fold's real inputs."""
    k, n = base.shape
    muls = (n * k * (3 * MULS["madd"] + 4 * MULS["dbl"] + 7)  # multiples
            + n * 63 * 4 * MULS["dbl"]                # doublings after w=63
            + int((dig != 8).sum()) * MULS["padd_cached"]  # digits != 0
            + n * (MULS["inv"] + 4))                  # Z inversion, affine
    return compare("ladder_fold", label,
                   lambda: ipa_fold.ladder_fold(src, base, dig),
                   lambda: ipa_fold.ladder_fold_plain(src, base, dig),
                   f"K={k} outputs={n}", muls, (src, base, dig))


def check_point_sum(ms, ws, label):
    """K7 against its plain version: (D - 1) x 9 field muls per lane; the
    bytes of the D chunks' window sums and of the sum."""
    d, _, _, n = ws.shape
    return compare("point_sum", label, lambda: ms.point_sum(ws),
                   lambda: ms.point_sum_plain(ws), f"D={d} lanes={n}",
                   (d - 1) * n * MULS["padd"], (ws,))


def d17_msm(ms, rd, digits, src, n):
    """Phase 5: merkle32's k=3 commitment MSM in point chunks of 2^13
    (D = 17) against the same MSM in one chunk: equal encodings, one K7
    launch; then K7 against its plain version on the 17 chunks' window
    sums."""
    import torch
    stacks, point_sum = [], ms.point_sum

    def record_sum(ws):
        stacks.append(ws)
        return point_sum(ws)
    before = ms.LAUNCHES["point_sum"]
    ms.point_sum = record_sum
    try:
        chunked = rd.ristretto_compress(msm_points(
            ms, digits, src, n, point_chunk=POINT_CHUNK_D17))
        torch.cuda.synchronize()
    finally:
        ms.point_sum = point_sum
    launched = ms.LAUNCHES["point_sum"] - before
    whole = rd.ristretto_compress(msm_points(ms, digits, src, n,
                                             point_chunk=n))
    d = stacks[0].shape[0] if stacks else 0
    if launched != 1 or d != 17 or not torch.equal(chunked, whole):
        raise AssertionError(f"merkle32 commitments in chunks of "
                             f"{POINT_CHUNK_D17}: {d} chunks, {launched} K7 "
                             "launches (want 17, 1), or encodings differ "
                             "from one chunk's")
    say(f"merkle32's k=3 commitment MSM ({n} points) in 17 point chunks of "
        f"{POINT_CHUNK_D17}: one K7 launch, encodings equal to the unchunked "
        "MSM's")
    return check_point_sum(ms, stacks[0], "merkle32 commitments, 17 chunks")


def msm_points(ms, *args, **kw):
    """msm_digits_t's points [4, NL, k], its pool excess read (a sync)
    and required to be <= 0."""
    cols, excess = ms.msm_digits_t(*args, **kw)
    if int(excess) > 0:
        raise AssertionError(f"MSM pool past its bound by {int(excess)}")
    return cols


def launch_floor(ms, device):
    """Phase 5: what a launch that does almost nothing costs on the card
    (CUDA events, mean of 100 back-to-back launches): K7 on one lane of two
    chunks, and a one-element PyTorch fill."""
    import torch
    ws = torch.zeros((2, 4, ms.NL, 1), dtype=torch.int32, device=device)
    one = torch.zeros(1, device=device)
    t_k7 = timed(lambda: ms.point_sum(ws), 100)[0]
    t_fill = timed(lambda: one.fill_(1.0), 100)[0]
    say(f"launch floor: K7 on one lane of two chunks {t_k7:.4f} ms, a "
        f"one-element fill {t_fill:.4f} ms")
    return t_k7, t_fill


def edge_points(n, seed):
    """The identity and n - 1 seeded points with Z != 1, as int32 [4, NL,
    n] limbs, each limb at or above half its width lent to the next one
    (negative limbs, as the 10-limb kernels write them)."""
    import torch
    from bulletproof_gadgets_tpu_torch.core.ristretto import (
        RISTRETTO_BASEPOINT, RistrettoPoint)
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.ops import fp
    r = random.Random(seed)
    pts = [RistrettoPoint.identity()]
    for _ in range(n - 1):
        q = RISTRETTO_BASEPOINT.scalar_mul(r.randrange(L))
        z = r.randrange(1, FIELD_P)
        pts.append(RistrettoPoint(q.X * z, q.Y * z, q.Z * z, q.T * z))
    c = np.stack([fp.ints_to_limbs([getattr(p, a) for p in pts])
                  for a in "XYZT"]).astype(np.int64)
    for i in range(fp.NL - 1):
        big = c[:, i] >= 1 << (fp.W[i] - 1)
        c[:, i] -= big << fp.W[i]
        c[:, i + 1] += big
    return torch.from_numpy(c.astype(np.int32)), [p.compress() for p in pts]


EDGE_LENGTHS = (0, 10, 60, 100, 120, 140, 150, 160)


def edge_transcripts(device, lengths=EDGE_LENGTHS):
    """Host transcripts whose STROBE position differs (a prior message of
    each length, so a round's absorbs cross the 166-byte rate at different
    bytes) -> their device states and positions."""
    from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
    from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript
    r = random.Random(len(lengths))
    ts = []
    for n in lengths:
        t = Transcript(b"chip-smoke")
        t.append_message(b"V", bytes(r.randrange(256) for _ in range(n)))
        ts.append(t)
    return sd.snapshot(ts, device)


def challenge_strings(n, seed):
    """CHALLENGE_EDGES as 64-byte strings, then seeded ones up to n."""
    r = random.Random(seed)
    return [v.to_bytes(64, "little") for v in CHALLENGE_EDGES] + [
        bytes(r.randrange(256) for _ in range(64))
        for _ in range(n - len(CHALLENGE_EDGES))]


def transcript_work(meta, u_rows, lat):
    """(word products, latency bound ms) of one transcript_round launch on
    these inputs: per transcript TRANSCRIPT_FL8_PRODUCTS fl8 products and
    its inversion's products (fl_inversion_products of u 2^256 mod l, u
    from the output's Montgomery row); the chain of the slowest transcript,
    one f1600 or two (when its absorbs reach the rate and leave pos != 0),
    two fl8 products and one inversion."""
    words, f1600 = 0, 1
    for (pos, _, _), row in zip(meta.tolist(), u_rows[:, 0].tolist()):
        u = (sum(int(v) << (26 * j) for j, v in enumerate(row))
             * pow(2, -260, FIELD_L) % FIELD_L)
        words += (TRANSCRIPT_FL8_PRODUCTS * FL8_WORD_PRODUCTS
                  + fl_inversion_products((u << 256) % FIELD_L))
        f1600 = max(f1600, 2 if pos + ROUND_ABSORBED > 166 else 1)
    return words, (f1600 * lat["f1600"] + 2 * lat["fl8_mont_mul"]
                   + lat["fl8_inv"])


def check_transcript_kernels(rd, sd, rec, device):
    """Phase 10: ristretto_compress and transcript_round against their
    plain versions (tolerance 0), with times, bounds and latency bounds
    (from the one-thread probes), on merkle32's warm prove (its
    commitments' points and the last IPA round's points, states, positions
    and encodings, recorded in phase 4) and on edge inputs: the identity
    and 63 random points with carried limbs (also against the host's
    encodings); 8 and 33 transcripts at the eight byte positions over four
    chained rounds; challenge_rows on 64 chosen challenge strings
    (CHALLENGE_EDGES, then seeded)."""
    import torch
    res = {}
    lat = product_latency(device)
    compress_chain = (COMPRESS_CHAIN_SQR * lat["fe8_sqr"]
                      + COMPRESS_CHAIN_MUL * lat["fe8_mul"])

    def compress(cols, label):
        k = cols.shape[2]
        return compare("ristretto_compress", label,
                       lambda: rd.ristretto_compress(cols),
                       lambda: rd.compress_cols(cols), f"k={k}",
                       k * COMPRESS_WORD_PRODUCTS, (cols,), compress_chain)

    def round_(state, meta, enc, label):
        b = state.shape[0]
        words, chain = transcript_work(
            meta, sd.transcript_round_plain(state, meta, enc)[2], lat)
        return compare("transcript_round", label,
                       lambda: sd.transcript_round(state, meta, enc),
                       lambda: sd.transcript_round_plain(state, meta, enc),
                       f"B={b}", words, (state, meta, enc), chain)
    one_f1600 = lat["f1600"] + 2 * lat["fl8_mont_mul"] + lat["fl8_inv"]
    say(f"latency bounds: ristretto_compress {compress_chain:.4g} ms "
        f"({COMPRESS_CHAIN_SQR} fe8_sqr + {COMPRESS_CHAIN_MUL} fe8_mul); "
        f"transcript_round {one_f1600:.4g} ms with one f1600 (f1600, 2 "
        "fl8_mont_mul, fl8_inv), one f1600 more where a round's absorbs "
        "reach the rate")
    compress(rec["commitments"], "merkle32 commitments")
    res["ristretto_compress"] = compress(rec["round"], "merkle32 IPA round")
    cols, want = edge_points(64, 10)
    cols = cols.to(device)
    compress(cols, "identity + 63 random points, carried limbs")
    got = [bytes(r) for r in rd.ristretto_compress(cols).cpu().numpy()]
    if got != want:
        raise AssertionError("ristretto_compress != the host's encodings")
    res["transcript_round"] = round_(*rec["transcript"],
                                     "merkle32 IPA round")
    g = torch.Generator().manual_seed(4)
    for b in (8, 33):
        state, meta = edge_transcripts(
            device, tuple(EDGE_LENGTHS[i % 8] for i in range(b)))
        for i in range(4):
            enc = torch.randint(0, 256, (b, 2, 32), generator=g,
                                dtype=torch.uint8).to(device)
            round_(state, meta, enc, f"{b} at 8 positions, round {i}")
            state, meta, _ = sd.transcript_round(state, meta, enc)
    ch = torch.tensor([list(c) for c in challenge_strings(64, 64)],
                      dtype=torch.uint8, device=device)
    got, plain = sd.challenge_rows(ch), sd.challenge_rows_plain(ch)
    if not torch.equal(got, plain):
        raise AssertionError("challenge_rows != plain on chosen strings")
    say("transcript_round's F_l part (challenge_rows) equal to plain on 64 "
        "chosen challenge strings (tolerance 0)")
    return res


def k1_per_entry(ms, digits, src, n, chunk):
    """K1's ns per live bucket entry over an MSM's point chunks (CUDA
    events, mean of 5 per chunk)."""
    total_ms, entries = 0.0, 0
    for lo in range(0, n, chunk):
        idx, _, _ = ms.plan(digits[:, lo:lo + chunk], n, lo)
        total_ms += timed(lambda: ms.bucket_accumulate(src, idx), 5)[0]
        entries += int((idx != 2 * n).sum())
    return 1e6 * total_ms / entries, total_ms, entries


def batch_path(pins, ms):
    """Phase 6: the batch pins, then example x 3 and merkle32 x 3 stacked
    and with max_k=3, with the launch counters reset just before and read
    just after.  Returns (launches, the first K2 call's inputs on
    merkle32, merkle32's stacked commitment digits (digits, src, n))."""
    from bulletproof_gadgets_tpu_torch.core import msm as core_msm
    from bulletproof_gadgets_tpu_torch.lang.batch import verify_batch
    from bulletproof_gadgets_tpu_torch.ops import mimc_kernels
    conts, stacked, hashed, outs = [], [], [], {}
    cont, msm_digits_t = ms.bucket_accumulate_cont, ms.msm_digits_t
    hash_batch = mimc_kernels.mimc_hash_batch

    def timed_hash(preimages, device):
        t0 = time.time()
        out = hash_batch(preimages, device)
        hashed.append((preimages, time.time() - t0))
        return out

    def host_hash_s(preimages):
        """The host sponge's time for the same preimages (no cache)."""
        from bulletproof_gadgets_tpu_torch.models import mimc
        from bulletproof_gadgets_tpu_torch.utils.conversions import (
            be_to_scalars)
        t0 = time.time()
        for data in preimages:
            mimc.mimc_sponge([v.v for v in mimc.pad_preimage(
                be_to_scalars(data))])
        return time.time() - t0

    def record_cont(src, idx, acc):
        if not conts:
            conts.append((src, idx, acc))
        return cont(src, idx, acc)

    def record_stacked(digits, src, n, *a, **kw):
        if not stacked and digits.shape[0] == 9 * ms.W and n > ms.POINT_CHUNK:
            stacked.append((digits, src, n))
        return msm_digits_t(digits, src, n, *a, **kw)

    def run(name, st, witnesses, **kw):
        return seeded_batch(pins, name, st, witnesses, **kw)

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    ms.bucket_accumulate_cont, ms.msm_digits_t = record_cont, record_stacked
    mimc_kernels.mimc_hash_batch = timed_hash
    try:
        for pin, b in pins["batches"].items():
            core_msm.set_table_min_size(b["table_min_size"])
            try:
                out, t_b = run(b["name"], b, b["witnesses"])
            finally:
                core_msm.set_table_min_size(None)
            if ([sha(p) for p, _, _ in out] != b["proof_sha256"]
                    or [sha(c.encode()) for _, _, c in out]
                    != b["coms_sha256"]):
                raise AssertionError(f"{pin}: proofs or .coms differ from "
                                     "the JAX package's prove_batch pin")
            say(f"batch pin {pin}: 3 proofs and .coms equal the pin "
                f"({t_b:.2f} s)")
        for name in ("example", "merkle32"):
            st = pins["statements"][name]
            k2 = ms.LAUNCHES["bucket_accumulate_cont"]
            del hashed[:]
            # the first batch also hashes the MiMC images on the device
            first_out, t_f = run(name, st, [st["witness"]] * 3)
            todo = [d for pre, _ in hashed for d in pre]
            images = (f"{len(todo)} images on the device in "
                      f"{sum(t for _, t in hashed):.2f} s, on the host "
                      f"{host_hash_s(todo):.3f} s")
            k2 = ms.LAUNCHES["bucket_accumulate_cont"] - k2
            single_out, t_u = run(name, st, [st["witness"]] * 3, max_k=3)
            stacked_out, t_s = run(name, st, [st["witness"]] * 3)
            if not first_out == single_out == stacked_out:
                raise AssertionError(f"{name} x 3: stacked and max_k=3 "
                                     "batches differ")
            if len({p for p, _, _ in stacked_out}) != 3:
                raise AssertionError(f"{name} x 3: proofs not distinct")
            outs[name] = stacked_out
            proofs = [(p, c) for p, _, c in stacked_out]
            bad = bytearray(proofs[0][0])
            bad[len(bad) // 2] ^= 1
            t0 = time.time()
            oks = verify_batch(name, st["instance"],
                               proofs + [(bytes(bad), proofs[0][1])],
                               st["gadgets"])
            t_v = time.time() - t0
            if oks != [True, True, True, False]:
                raise AssertionError(f"{name} x 3: verify_batch {oks}, want "
                                     "3 x true then false (tampered)")
            say(f"batch {name} x 3: stacked first {t_f:.2f} s (with the "
                f"image hashing: {images}), then max_k=3 {t_u:.2f} s, stacked "
                f"{t_s:.2f} s, byte-equal; verify_batch {t_v:.2f} s: 3 true, "
                f"tampered false; K2 launches in the first stacked batch: "
                f"{k2}")
            if name == "merkle32" and k2 == 0:
                raise AssertionError("merkle32 x 3: K2 was not launched")
        launches = dict(ms.LAUNCHES)
    finally:
        ms.bucket_accumulate_cont, ms.msm_digits_t = cont, msm_digits_t
        mimc_kernels.mimc_hash_batch = hash_batch
    idle = [k for k in KERNELS
            if launches[k] == 0 and k not in OTHER_LAYOUTS]
    if idle:
        raise AssertionError(f"kernels not launched by the batch path: "
                             f"{idle}")
    say(f"batch path launches: {launches}")
    return launches, conts[0], stacked[0], outs


def seeded_batch(pins, name, st, witnesses, **kw):
    """prove_batch under the pinned blinding seed -> (results, s)."""
    from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng
    blind_rng.set_seed(pins["seed"])
    try:
        t0 = time.time()
        out = prove_batch(name, st["instance"], witnesses, st["gadgets"],
                          **kw)
        return out, time.time() - t0
    finally:
        blind_rng.set_seed(None)


def check_cont(ms, src, idx, acc):
    """Phase 7: K2 against its plain version on one round chunk of the
    merkle32 batch's stacked commitment MSM: K1's bound rule (7 field muls
    per live entry, accumulation_bytes) and the pool in and out."""
    entries = int((idx != src.shape[0] - 1).sum())
    return compare("bucket_accumulate_cont", "merkle32 x 3 round chunk",
                   lambda: ms.bucket_accumulate_cont(src, idx, acc),
                   lambda: ms.bucket_accumulate_cont_plain(src, idx, acc),
                   f"T={idx.shape[0]} P={idx.shape[1]}",
                   entries * MULS["madd"],
                   (accumulation_bytes(ms, idx, src.shape[0] - 1, src), acc))


def round_chunk_times(ms, digits, src, n):
    """Phase 7: on merkle32's stacked k = 9 commitment digits, the first
    point chunk's accumulation as K1 + K2 over round chunks of
    SLOT_BUDGET // P rounds against one K1 over all rounds (idx built
    beforehand; CUDA events, mean of 5 after a warm-up), and the whole
    msm_digits_t with slot_budget=SLOT_BUDGET and 0 (no round chunks):
    time and peak device memory."""
    import torch
    s = ms.schedule(digits[:, :ms.POINT_CHUNK], n, 0)
    tc = max(1, ms.SLOT_BUDGET // s.pool)
    chunks = [ms.idx_rows(s, t0, min(t0 + tc, s.t))
              for t0 in range(0, s.t, tc)]
    whole = ms.idx_rows(s, 0, s.t)

    def chunked():
        pool = ms.bucket_accumulate(src, chunks[0])
        for idx in chunks[1:]:
            pool = ms.bucket_accumulate_cont(src, idx, pool)
        return pool
    t_c, out_c = timed(chunked, 5)
    t_w, out_w = timed(lambda: ms.bucket_accumulate(src, whole), 5)
    if not torch.equal(out_c, out_w):
        raise AssertionError("K1 + K2 round-chunked != one K1")
    entries = int((whole != 2 * n).sum())
    say(f"round chunks on merkle32 x 3's k=9 commitment MSM, first point "
        f"chunk: T={s.t} P={s.pool} ({s.t * s.pool} slots, {entries} "
        f"entries), {len(chunks)} chunks of {tc} rounds: K1 + "
        f"{len(chunks) - 1} K2 {t_c:.3f} ms vs one K1 {t_w:.3f} ms (equal "
        "pools)")
    del chunks, whole
    for budget in (ms.SLOT_BUDGET, 0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_m, _ = timed(lambda: ms.msm_digits_t(digits, src, n,
                                               slot_budget=budget), 5)
        peak = torch.cuda.max_memory_allocated() - base
        say(f"msm_digits_t on those digits, slot_budget={budget}: "
            f"{t_m:.3f} ms, peak {peak / 2**20:.1f} MiB above its inputs")


def bound64_per_witness(device):
    """Phase 8: a batch of BOUND64_BATCH 64-bit BOUND witnesses against as
    many sequential proves, warm (one untimed run of each first): ms per witness on the
    host clock (each ends in a readback); all verify."""
    from bulletproof_gadgets_tpu_torch.lang.batch import (prove_batch,
                                                         verify_batch)
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    # the JAX package's batch benchmark statement (scripts/bench_batch.py)
    gadgets = "BOUND W0 I0 I1"
    instance = "I0 = 0x00\nI1 = 0xffffffffffffffff\n"
    r = random.Random(64)
    witnesses = [f"W0 = 0x{r.randrange(1, 1 << 63):016x}\n"
                 for _ in range(BOUND64_BATCH)]

    def batch():
        return prove_batch("bound64", instance, witnesses, gadgets)

    def sequential():
        out = []
        for w in witnesses:
            coms = []
            proof, _ = prove("bound64", instance, w, gadgets, coms)
            out.append((proof, "".join(coms)))
        return out
    times = {}
    for label, fn in (("batch", batch), ("sequential", sequential)):
        fn()
        t0 = time.time()
        out = fn()
        times[label] = time.time() - t0
        pairs = [(o[0], o[-1]) for o in out]
        if verify_batch("bound64", instance, pairs, gadgets) != \
                [True] * BOUND64_BATCH:
            raise AssertionError(f"bound64 {label}: a proof failed to verify")
    n = BOUND64_BATCH
    say(f"64-bit BOUND x {n} on {device}: batch "
        f"{1e3 * times['batch'] / n:.2f} ms per witness, sequential "
        f"{1e3 * times['sequential'] / n:.2f} ms per witness (warm, all "
        "verify)")


def check_layout_kernels(ms, ex_call, k2_in):
    """Phase 9 (a): K8 and K10 against their plain versions on the
    example's k=3 commitment launch, K9 on the merkle32 x 3 round chunk
    (tolerance 0; 7 field muls per live entry, the gathered coordinates'
    bytes up to each lane's stop (accumulation_bytes), the pool written
    and, for K9, read), and their pools
    against K1's / K2's on the same idx."""
    import torch
    digits, src, n = ex_call
    idx, _, _ = ms.plan(digits, n)
    t, p = idx.shape
    muls = int((idx != 2 * n).sum()) * MULS["madd"]
    g_bytes = accumulation_bytes(ms, idx, 2 * n)
    pool = ms.bucket_accumulate(src, idx)
    label, shape = "example k=3 commitment launch", f"T={t} P={p}"
    res = {}
    g = ms.gather_cols(src, idx)
    res["bucket_accumulate_cols"] = compare(
        "bucket_accumulate_cols", label, lambda: ms.bucket_accumulate_cols(g),
        lambda: ms.bucket_accumulate_cols_plain(g), shape, muls, (g_bytes,))
    same = torch.equal(ms.bucket_accumulate_cols(g), pool)
    g = ms.gather_flat(src, idx)
    res["bucket_accumulate_flat"] = compare(
        "bucket_accumulate_flat", label,
        lambda: ms.bucket_accumulate_flat(g, t, p),
        lambda: ms.bucket_accumulate_flat_plain(g, t, p), shape, muls,
        (g_bytes,))
    same &= torch.equal(ms.bucket_accumulate_flat(g, t, p), pool)
    src, idx, acc = k2_in
    g = ms.gather_cols(src, idx)
    res["bucket_accumulate_cols_cont"] = compare(
        "bucket_accumulate_cols_cont", "merkle32 x 3 round chunk",
        lambda: ms.bucket_accumulate_cols_cont(g, acc),
        lambda: ms.bucket_accumulate_cols_cont_plain(g, acc),
        f"T={idx.shape[0]} P={idx.shape[1]}",
        int((idx != src.shape[0] - 1).sum()) * MULS["madd"],
        (accumulation_bytes(ms, idx, src.shape[0] - 1), acc))
    same &= torch.equal(ms.bucket_accumulate_cols_cont(g, acc),
                        ms.bucket_accumulate_cont(src, idx, acc))
    if not same:
        raise AssertionError("K8 / K10 pool != K1's or K9 pool != K2's on "
                             "the same idx")
    say("K8 and K10 pools equal K1's on the example launch; K9's equals "
        "K2's on the round chunk")
    return res


def layout_times(ms, label, src, idx, acc=None):
    """Phase 9 (b) on one accumulation's idx (with acc: a round chunk that
    carries its pool): K1 (K2) against gather_cols + K8 (K9) and
    gather_flat + K10 (from the identity, the same rounds), CUDA events,
    mean of 5 after a warm-up; each gather alone; the peak device memory of
    each accumulation above its inputs."""
    import torch
    t, p = idx.shape

    def measure(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_ms, _ = timed(fn, 5)
        return t_ms, (torch.cuda.max_memory_allocated() - base) / 2**20
    if acc is None:
        rows = measure(lambda: ms.bucket_accumulate(src, idx))
        cols = measure(lambda: ms.bucket_accumulate_cols(
            ms.gather_cols(src, idx)))
    else:
        rows = measure(lambda: ms.bucket_accumulate_cont(src, idx, acc))
        cols = measure(lambda: ms.bucket_accumulate_cols_cont(
            ms.gather_cols(src, idx), acc))
    flat = measure(lambda: ms.bucket_accumulate_flat(
        ms.gather_flat(src, idx), t, p))
    g_cols = timed(lambda: ms.gather_cols(src, idx), 5)[0]
    g_flat = timed(lambda: ms.gather_flat(src, idx), 5)[0]
    k1, k8 = ("K2", "K9") if acc is not None else ("K1", "K8")
    say(f"layouts on {label} (T={t} P={p}, {t * p} slots): rows {k1} "
        f"{rows[0]:.3f} ms (peak {rows[1]:.1f} MiB); cols gather "
        f"{g_cols:.3f} ms, gather + {k8} {cols[0]:.3f} ms (peak "
        f"{cols[1]:.1f} MiB); flat gather {g_flat:.3f} ms, gather + K10 "
        f"{flat[0]:.3f} ms (peak {flat[1]:.1f} MiB)")


def layout_msm_times(ms, label, digits, src, n):
    """Phase 9 (b): one whole msm_digits_t under each layout (CUDA events,
    mean of 5 after a warm-up; peak device memory above its inputs); the
    three must give equal limbs."""
    import torch
    parts, ref = [], None
    for layout in ms.LAYOUTS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_m, (out, excess) = timed(lambda: ms.msm_digits_t(
            digits, src, n, layout=layout), 5)
        if int(excess) > 0:
            raise AssertionError(f"msm_digits_t on {label}: pool excess")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        if ref is None:
            ref = out
        elif not torch.equal(out, ref):
            raise AssertionError(f"msm_digits_t on {label}: {layout} != rows")
        parts.append(f"{layout} {t_m:.3f} ms (peak {peak:.1f} MiB)")
    say(f"msm_digits_t on {label} ({n} points, k={digits.shape[0] // ms.W}): "
        + ", ".join(parts) + "; equal limbs")


def layout_path(pins, ms, engine, layout, rows_batch):
    """Phase 9 (c): the four pinned statements (first and warm) and
    merkle32 x 3 stacked under engine.register("cuda", msm_layout=layout),
    the launch counters reset just before and read just after; the
    layout's kernels must launch and no other layout's.  Returns the
    launches."""
    from bulletproof_gadgets_tpu_torch.lang.batch import verify_batch
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    def since(before):                # this layout's launches since before
        return {k: ms.LAUNCHES[k] - before[k] for k in LAYOUT_KERNELS[layout]}
    engine.register("cuda", msm_layout=layout)
    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    try:
        for name in ("bound16", "less_than", "example", "merkle32"):
            st = pins["statements"][name]
            times = []
            for _ in range(2):                   # first, then warm
                before = dict(ms.LAUNCHES)
                blind_rng.set_seed(pins["seed"])
                coms = []
                try:
                    t0 = time.time()
                    proof, _ = prove(name, st["instance"], st["witness"],
                                     st["gadgets"], coms)
                    t_prove = time.time() - t0
                finally:
                    blind_rng.set_seed(None)
                coms = "".join(coms)
                if (sha(proof) != st["proof_sha256"]
                        or sha(coms.encode()) != st["coms_sha256"]):
                    raise AssertionError(f"{layout}: {name}: proof or .coms "
                                         "differ from the JAX package's pin")
                t0 = time.time()
                if not verify(name, st["instance"], proof, coms,
                              st["gadgets"]):
                    raise AssertionError(f"{layout}: {name}: verify false")
                times.append((t_prove, time.time() - t0))
            warm = since(before)                 # the warm prove + verify
            bad = bytearray(proof)
            bad[len(bad) // 2] ^= 1
            if verify(name, st["instance"], bytes(bad), coms, st["gadgets"]):
                raise AssertionError(f"{layout}: {name}: tampered proof "
                                     "verified")
            say(f"layout {layout}: statement {name}: proof and .coms equal "
                f"the pins, verify true, tampered false; prove first "
                f"{times[0][0]:.2f} s warm {times[1][0]:.2f} s, verify first "
                f"{times[0][1]:.2f} s warm {times[1][1]:.2f} s; launches "
                f"per prove + verify {warm}")
        st = pins["statements"]["merkle32"]
        before = dict(ms.LAUNCHES)
        out, t_b = seeded_batch(pins, "merkle32", st, [st["witness"]] * 3)
        batch = since(before)
        if out != rows_batch:
            raise AssertionError(f"{layout}: merkle32 x 3 differs from the "
                                 "rows layout's batch")
        t0 = time.time()
        oks = verify_batch("merkle32", st["instance"],
                           [(p, c) for p, _, c in out], st["gadgets"])
        if oks != [True] * 3:
            raise AssertionError(f"{layout}: merkle32 x 3 verify {oks}")
        say(f"layout {layout}: merkle32 x 3 stacked {t_b:.2f} s, byte-equal "
            f"to the rows batch, launches {batch}; verify_batch "
            f"{time.time() - t0:.2f} s, 3 true")
        launches = dict(ms.LAUNCHES)
    finally:
        engine.register("cuda")
    missing = [k for k in LAYOUT_KERNELS[layout] if launches[k] == 0]
    stray = [k for other, ks in LAYOUT_KERNELS.items() if other != layout
             for k in ks if launches[k]]
    if missing or stray:
        raise AssertionError(f"layout {layout}: kernels not launched "
                             f"{missing}, other layouts' kernels launched "
                             f"{stray}")
    say(f"layout {layout} launches: {launches}")
    return launches

SURFACE_STATEMENTS = ("example", "merkle32", "or_flat", "or_nested")
# kernels phase 11 (a)'s requests must launch (point_sum: merkle32's chunks)
SURFACE_KERNELS = ("bucket_accumulate", "bucket_merge", "window_sums",
                   "horner", "ladder_fold", "point_sum", "ristretto_compress",
                   "transcript_round")
TRANSCRIPT_PAIRS = 8            # phase 11 (e): C / Python transcript pairs
TRANSCRIPT_ROUNDS = 200         # IPA rounds' absorbs timed on each


def surfaces(pins, ms, engine, direct):
    """Phase 11: the embedding surfaces on the card.  (a) the HTTP service
    (cli/serve.Handler in this process): prove and verify the pinned
    example, merkle32 and OR statements, first and warm, the launch
    counters reset just before and read just after; (b) the C ABI loaded
    into this process; (c) the C ABI embedded in a C program, a fresh
    process; (d) the JNI layer through jni_host.FakeJNI; (e) warm merkle32
    with the C transcript and with the Python one in alternating pairs.
    Returns (a)'s launches."""
    import ctypes
    import statistics
    import sysconfig
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from bulletproof_gadgets_tpu_torch import capi
    from bulletproof_gadgets_tpu_torch.capi import jni_host
    from bulletproof_gadgets_tpu_torch.cli import serve
    from bulletproof_gadgets_tpu_torch.lang import prove as lp
    from bulletproof_gadgets_tpu_torch.lang import verify as lv
    from bulletproof_gadgets_tpu_torch.utils import merlin
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    def tampered(proof):
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        return bytes(bad)

    def check(label, name, proof, coms):
        st = pins["statements"][name]
        if sha(proof) != st["proof_sha256"] or sha(coms) != st["coms_sha256"]:
            raise AssertionError(f"{label}: {name}: proof or .coms differ "
                                 "from the JAX package's pin")

    # (a) the HTTP service
    if engine.use().type != "cuda":
        raise AssertionError(f"phase 11 on {engine.use()}, not CUDA")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.time()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read()), time.time() - t0
        except urllib.error.HTTPError as e:
            raise AssertionError(f"HTTP {path}: {e.code} {e.read()!r}")

    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    try:
        for name in SURFACE_STATEMENTS:
            st = pins["statements"][name]
            times = []
            for _ in range(2):                   # first, then warm
                blind_rng.set_seed(pins["seed"])
                try:
                    out, t_prove = post("/prove", {
                        "name": name, "instance": st["instance"],
                        "witness": st["witness"], "gadgets": st["gadgets"]})
                finally:
                    blind_rng.set_seed(None)
                proof = bytes.fromhex(out["proof"])
                check("HTTP", name, proof, out["commitments"].encode())
                req = {"name": name, "instance": st["instance"],
                       "proof": out["proof"],
                       "commitments": out["commitments"],
                       "gadgets": st["gadgets"]}
                res, t_verify = post("/verify", req)
                if res != {"verified": True}:
                    raise AssertionError(f"HTTP: {name}: verify {res}")
                times.append((t_prove, t_verify))
            req["proof"] = tampered(proof).hex()
            if post("/verify", req)[0] != {"verified": False}:
                raise AssertionError(f"HTTP: {name}: tampered proof verified")
            d = (f"{direct[name][0]:.3f} s / {direct[name][1]:.3f} s"
                 if name in direct else "not run")
            say(f"HTTP {name}: proof and .coms equal the pins, verify true, "
                f"tampered false; per request prove first {times[0][0]:.3f} "
                f"s warm {times[1][0]:.3f} s, verify first {times[0][1]:.3f} "
                f"s warm {times[1][1]:.3f} s; phase 4's direct warm prove / "
                f"verify {d}")
        launches = dict(ms.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    idle = [k for k in SURFACE_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"HTTP: kernels not launched: {idle}")
    say(f"HTTP launches: {launches}")

    # (b) the C ABI loaded into this process
    st = pins["statements"]["example"]
    inst, wtns, gad = (st[k].encode() for k in ("instance", "witness",
                                                "gadgets"))
    lib = capi.load_ffi()
    blind_rng.set_seed(pins["seed"])
    try:
        t0 = time.time()
        art = lib.c_prove(b"example", inst, wtns, gad)
        t_prove = time.time() - t0
    finally:
        blind_rng.set_seed(None)
    if not art:
        raise AssertionError("C ABI: c_prove returned NULL")
    proof = ctypes.string_at(art.contents.proof, art.contents.len)
    coms = art.contents.commitments
    lib.free_proof(art)
    check("C ABI", "example", proof, coms)
    bad = tampered(proof)
    verdicts = (lib.c_verify(b"example", inst, proof, len(proof), coms, gad),
                lib.c_verify(b"example", inst, bad, len(bad), coms, gad))
    if verdicts != (1, 0):
        raise AssertionError(f"C ABI: c_verify {verdicts}, want (1, 0)")
    say(f"C ABI in this process: example proof and .coms equal the pins "
        f"(c_prove {t_prove:.3f} s), c_verify 1, tampered 0")

    # (c) the C ABI embedded in a C program
    exe = capi.embed_program()
    path = [ROOT, sysconfig.get_paths()["purelib"]]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    env = dict(os.environ, BPG_TPU_SEED=pins["seed"], BPG_TORCH_DEVICE="cuda",
               PYTHONPATH=os.pathsep.join(path))
    with tempfile.TemporaryDirectory() as tmp:
        for ext, key in ((".inst", "instance"), (".wtns", "witness"),
                         (".gadgets", "gadgets")):
            with open(os.path.join(tmp, f"example{ext}"), "w") as f:
                f.write(st[key])
        t0 = time.time()
        out = subprocess.run([exe, tmp, "example"], capture_output=True,
                             text=True, env=env, timeout=600)
        t_run = time.time() - t0
    lines = out.stdout.splitlines()
    if out.returncode != 0 or len(lines) != 3:
        raise AssertionError(f"C program: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-6000:]}")
    digest = sha(bytes.fromhex(lines[0]))
    if (digest, lines[1:]) != (st["proof_sha256"],
                               ["true", "tampered false"]):
        raise AssertionError(f"C program: proof sha256 {digest}, {lines[1:]}")
    say(f"C program (a fresh process, CPython, PyTorch and CUDA started by "
        f"c_prove): example proof sha256 {digest} equals the pin, true, "
        f"tampered false, in {t_run:.1f} s")

    # (d) the JNI layer
    ext_prove, ext_verify = jni_host.entry_points(capi.jni_library())
    wrapper = {"name": "example", "instance": st["instance"],
               "witness": st["witness"], "gadgets": st["gadgets"]}
    jni = jni_host.FakeJNI(wrapper)
    blind_rng.set_seed(pins["seed"])
    try:
        ext_prove(jni.env, None, 1)
    finally:
        blind_rng.set_seed(None)
    if "proof" not in wrapper:
        raise AssertionError("JNI: extProve set no proof")
    check("JNI", "example", bytes(wrapper["proof"]),
          wrapper["commitments"].encode())
    bad = jni_host.FakeJNI(dict(wrapper, proof=bytearray(
        tampered(bytes(wrapper["proof"])))))
    verdicts = (ext_verify(jni.env, None, 1), ext_verify(bad.env, None, 1))
    if verdicts != (1, 0):
        raise AssertionError(f"JNI: extVerify {verdicts}, want (1, 0)")
    say("JNI: example proof and .coms equal the pins, extVerify 1, "
        "tampered 0")

    # (e) the host transcript: C against Python on warm merkle32
    st = pins["statements"]["merkle32"]

    def run(transcript):
        lp.Transcript = lv.Transcript = transcript
        try:
            blind_rng.set_seed(pins["seed"])
            coms = []
            try:
                t0 = time.time()
                proof, _ = lp.prove("merkle32", st["instance"],
                                    st["witness"], st["gadgets"], coms)
                t_p = time.time() - t0
            finally:
                blind_rng.set_seed(None)
            t0 = time.time()
            ok = lv.verify("merkle32", st["instance"], proof, "".join(coms),
                           st["gadgets"])
            t_v = time.time() - t0
        finally:
            lp.Transcript = lv.Transcript = merlin.new_transcript
        check(f"transcript {transcript.__name__}", "merkle32", proof,
              "".join(coms).encode())
        if not ok:
            raise AssertionError(f"{transcript.__name__}: merkle32 verify "
                                 "false")
        return t_p, t_v

    sides = {"C": capi.NativeTranscript, "Python": merlin.Transcript}
    runs = {side: [] for side in sides}
    run(sides["C"])                              # warm
    for i in range(TRANSCRIPT_PAIRS):
        for side in (("C", "Python") if i % 2 == 0 else ("Python", "C")):
            runs[side].append(run(sides[side]))
    for side, make in sides.items():
        t = make(b"ipa")
        t0 = time.perf_counter()
        for _ in range(TRANSCRIPT_ROUNDS):
            t.append_message(b"L", bytes(32))
            t.append_message(b"R", bytes(32))
            t.challenge_bytes(b"u", 64)
        per_round = (time.perf_counter() - t0) / TRANSCRIPT_ROUNDS
        p, v = ([r[j] for r in runs[side]] for j in (0, 1))
        say(f"host transcript {side}: warm merkle32 prove median "
            f"{statistics.median(p):.4f} s [{min(p):.4f}, {max(p):.4f}], "
            f"verify median {statistics.median(v):.4f} s [{min(v):.4f}, "
            f"{max(v):.4f}] over {TRANSCRIPT_PAIRS} alternating pairs, "
            f"bytes equal the pin; one IPA round's absorbs and challenge "
            f"{per_round * 1e6:.1f} us")
    for j, what in ((0, "prove"), (1, "verify")):
        diffs = [c[j] - p[j] for c, p in zip(runs["C"], runs["Python"])]
        say(f"host transcript C less Python, warm merkle32 {what}: median "
            f"{statistics.median(diffs) * 1e3:.1f} ms [{min(diffs) * 1e3:.1f}"
            f", {max(diffs) * 1e3:.1f}] over the pairs, C faster in "
            f"{sum(d < 0 for d in diffs)} of {len(diffs)}")
    return launches


def counted_syncs(torch, ipa_fused, fn, *args, **kw):
    """fn(*args, **kw) (an ipa_fused.create) under torch.cuda's sync debug
    mode -> (its result, {"before": synchronizing calls before its round
    loop (the first `_scalars`), "rounds": those from there to `_finish`,
    "finish": those in `_finish`, its one readback})."""
    import warnings
    marks = {}
    scalars, finish = ipa_fused._scalars, ipa_fused._finish

    def syncs():
        return sum("synchroniz" in str(w.message) for w in caught)

    def spy_scalars(*a):
        marks.setdefault("loop", syncs())
        return scalars(*a)

    def spy_finish(*a):
        marks["finish"] = syncs()
        return finish(*a)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ipa_fused._scalars, ipa_fused._finish = spy_scalars, spy_finish
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            ipa_fused._scalars, ipa_fused._finish = scalars, finish
    total = syncs()
    return out, {"before": marks["loop"],
                 "rounds": marks["finish"] - marks["loop"],
                 "finish": total - marks["finish"]}


def stress_phase(pins, ms, m32_ns):
    """Phase 12: the stress circuit (scripts/run_stress_512_torch.run) in
    this process: first its 4-leaf pin (tests/port_pins.json "stress"),
    then 512 leaves on `rows` through scripts/profile_stress.stress_record
    (each phase's seconds, the counts against the JAX record, verify and
    the tampered copy, host peak RSS, device peak memory, launches per
    kernel; the commitments' k = 3 and the verifier's k = 1 table MSMs
    under rows and cols; K1 per entry on the table's first 2^17-point
    chunk beside merkle32's, m32_ns); the device generator map against the
    host's first 4,096 points.  Returns the 512-leaf run's launches."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import run_stress_512_torch as stress
    from profile_stress import stress_record
    from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
    from bulletproof_gadgets_tpu_torch.core.ristretto import RistrettoPoint
    from bulletproof_gadgets_tpu_torch.ops import ipa_fold
    pin = pins["stress"]["merkle_tree4"]
    t0 = time.time()
    r4 = stress.run(pin["leaves"], "rows", "cuda")
    got = (hashlib.sha256(r4["proof"]).hexdigest(),
           hashlib.sha256(r4["coms"]).hexdigest(), r4["constraints"],
           r4["multipliers"])
    if got != (pin["proof_sha256"], pin["coms_sha256"], pin["constraints"],
               pin["multipliers"]) or not r4["verify"] \
            or r4["tampered_verifies"]:
        raise AssertionError(f"merkle_tree4: {got}, verify {r4['verify']}, "
                             f"tampered {r4['tampered_verifies']}: not the "
                             "pin")
    say(f"stress pin merkle_tree4 ({pin['multipliers']} multipliers, "
        f"{pin['gens']} gens): proof and commitments equal the JAX "
        f"package's, verify true, tampered false, {time.time() - t0:.1f} s")
    say(f"host: {os.cpu_count()} CPUs")
    calls, folds, sums = [], [], []
    ladder_fold, point_sum = ipa_fold.ladder_fold, ms.point_sum

    def record_fold(src, base, dig):
        if not folds:
            folds.append((src, base, dig))
        return ladder_fold(src, base, dig)

    def record_sum(ws):
        if not sums:
            sums.append(ws)
        return point_sum(ws)
    ipa_fold.ladder_fold, ms.point_sum = record_fold, record_sum
    try:
        rec = stress_record(stress.run, ms, 512, say, calls)
    finally:
        ipa_fold.ladder_fold, ms.point_sum = ladder_fold, point_sum
    if any(rec[k] != v for k, v in stress.RECORD_512.items()) \
            or not rec["verify"] or rec["tampered_verifies"]:
        raise AssertionError(f"stress 512: {rec['constraints']} "
                             f"constraints, {rec['multipliers']} "
                             f"multipliers (want {stress.RECORD_512}), "
                             f"verify {rec['verify']}, tampered "
                             f"{rec['tampered_verifies']}")
    idle = [k for k in ("bucket_accumulate", "bucket_merge", "window_sums",
                        "horner", "ladder_fold", "point_sum",
                        "ristretto_compress", "transcript_round")
            if not rec["launches"].get(k)]
    if idle:
        raise AssertionError(f"stress 512: kernels not launched: {idle}")
    g_dev = BulletproofGens(1 << 20, device="cuda").G(4096)
    stream = hashlib.shake_256(b"GeneratorsChain" + b"G"
                               + (0).to_bytes(4, "little")).digest(64 * 4096)
    g_host = [RistrettoPoint.from_uniform_bytes(stream[64 * i:64 * (i + 1)])
              for i in range(4096)]
    if [(p.X, p.Y, p.Z, p.T) for p in g_dev] != \
            [(p.X, p.Y, p.Z, p.T) for p in g_host]:
        raise AssertionError("the device generator map differs from the "
                             "host's on the first 4,096 points")
    k1 = rec["msms"][f"k=3 over {2 * (1 << 20) + 2} points"]
    say(f"stress 512 (2^20 gens, rows): 1,986,769 constraints and 993,384 "
        f"multipliers as the JAX record, verify true, tampered false; "
        f"generators {rec['seconds']['generators']:.2f} s (device map, "
        f"equal to the host's first 4,096 points); host peak RSS "
        f"{rec['rss_gb']:.2f} GB; device peak "
        f"{rec['device_peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{rec['launches']} (K2 "
        f"{'launched' if rec['launches'].get('bucket_accumulate_cont') else 'not launched'}"
        f"); K1 on its first 2^17-point chunk (k = 3, past the L2) "
        f"{k1['k1_ns_per_entry']:.4f} ns per entry against merkle32's "
        f"{m32_ns:.4f} (within it)")
    # the stress path's kernels on its own inputs: K1, K3-K5 on the first
    # 2^17-point chunk of the commitments' and the verifier's table MSMs,
    # K6 on the first fold (2^20 gens to 131,072 outputs), K7 on the first
    # chunk combine (D = 17)
    if rec["launches"].get("bucket_accumulate_cont"):
        raise AssertionError("stress 512: K2 launched, and phase 12 holds "
                             "no round chunk of it against its plain version")
    for k, label in ((3, "commitments"), (1, "verifier")):
        digits, src, n = next(c for c in calls if c[0].shape[0] == k * ms.W)
        check_kernels(ms, digits[:, :ms.POINT_CHUNK], src, n,
                      f"stress k={k} {label}, first 2^17-point chunk")
    check_fold(ipa_fold, *folds[0], "stress first fold")
    check_point_sum(ms, sums[0], "stress first chunk combine")
    say("stress 512: K1, K3, K4, K5, K6 and K7 equal to their plain versions "
        "(tolerance 0) on the stress path's inputs; its launches "
        + ", ".join(f"{k} {v}" for k, v in sorted(rec["launches"].items())))
    return rec["launches"]


# phase 13: (ranks, statements) of each gloo world on the one card
MESH_WORLDS = ((2, ("example", "merkle32")), (4, ("example",)))
# kernels every rank's prove + verify must launch, and those it must not
# (the sharded argument folds scalars and keeps the host transcript)
MESH_KERNELS = ("bucket_accumulate", "bucket_merge", "window_sums",
                "horner", "point_sum", "ristretto_compress")
MESH_IDLE = ("ladder_fold", "transcript_round")
MESH_LIMIT = 600.0              # s per world, spawn to results


def mesh_rank(rank, world, names, device, pins_path):
    """Phase 13 (a) and (b), one rank of a gloo world on `device`: the mesh
    active, each statement proved first and warm under the pinned seed and
    verified through lang.prove / lang.verify (bytes equal to the pins,
    verify true, a tampered copy false), the launch counters reset before
    each statement and read after it; K7 on this world's first cross-rank
    combine (the example's commitment MSM) against its plain version.
    Raises on any difference: run_ranks fails the phase."""
    import torch
    sys.path.insert(0, ROOT)
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.ops import engine, msm_serial as ms
    from bulletproof_gadgets_tpu_torch.parallel import mesh as mesh_mod
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng
    with open(pins_path) as f:
        pins = json.load(f)
    engine.register(device)
    mesh = mesh_mod.make_mesh(device=device)
    mesh_mod.activate(mesh)
    combines, point_sum = [], ms.point_sum

    def record(ws):
        if not combines:
            combines.append(ws.clone())
        return point_sum(ws)
    ms.point_sum = record
    out = {"statements": {}}
    try:
        for name in names:
            st = pins["statements"][name]
            for k in ms.LAUNCHES:
                ms.LAUNCHES[k] = 0
            times = []
            for _ in range(2):                   # first, then warm
                blind_rng.set_seed(pins["seed"])
                coms = []
                before = {k: list(v) for k, v in mesh.traffic.items()}
                t0 = time.time()
                try:
                    proof, _ = prove(name, st["instance"], st["witness"],
                                     st["gadgets"], coms)
                finally:
                    blind_rng.set_seed(None)
                t_prove = time.time() - t0
                traffic = {k: [v[0] - before.get(k, [0, 0])[0],
                               v[1] - before.get(k, [0, 0])[1]]
                           for k, v in mesh.traffic.items()}
                coms = "".join(coms)
                if (hashlib.sha256(proof).hexdigest() != st["proof_sha256"]
                        or hashlib.sha256(coms.encode()).hexdigest()
                        != st["coms_sha256"]):
                    raise AssertionError(f"rank {rank} of {world}: {name} "
                                         "proof or .coms differ from the "
                                         "pin")
                t0 = time.time()
                if not verify(name, st["instance"], proof, coms,
                              st["gadgets"]):
                    raise AssertionError(f"rank {rank} of {world}: {name} "
                                         "verify returned false")
                times.append((t_prove, time.time() - t0))
            bad = bytearray(proof)
            bad[len(bad) // 2] ^= 1
            if verify(name, st["instance"], bytes(bad), coms, st["gadgets"]):
                raise AssertionError(f"rank {rank} of {world}: {name} "
                                     "tampered proof verified")
            launches = dict(ms.LAUNCHES)
            missing = [k for k in MESH_KERNELS if launches[k] == 0]
            stray = [k for k in MESH_IDLE if launches[k]]
            if missing or stray:
                raise AssertionError(f"rank {rank} of {world}: {name} "
                                     f"kernels not launched {missing}, "
                                     f"launched {stray}")
            out["statements"][name] = {"times": times, "launches": launches,
                                       "traffic": traffic}
    finally:
        ms.point_sum = point_sum
    if rank == 0:
        out["point_sum"] = check_point_sum(
            ms, combines[0], f"{world} ranks' example commitment window "
            "sums")
    return out


def nccl_rank(rank, world, device, rows, digits):
    """Phase 13 (c), one rank of an NCCL world of one on `device`: the mesh
    collectives on CUDA tensors; a ShardedGeneratorTable at D = 1 from the
    example table's rows against GeneratorTable on the example's k = 3
    commitment digits (the encodings equal); K7 on the rank's gathered
    window sums against its plain version (tolerance 0)."""
    import torch
    sys.path.insert(0, ROOT)
    from bulletproof_gadgets_tpu_torch.ops import msm_serial as ms
    from bulletproof_gadgets_tpu_torch.parallel import mesh as mesh_mod
    from bulletproof_gadgets_tpu_torch.parallel.sharded_serial import \
        ShardedGeneratorTable
    mesh = mesh_mod.make_mesh(device=device)
    if mesh.backend != "nccl" or mesh.shape["shard"] != 1:
        raise AssertionError(f"NCCL world: backend {mesh.backend}, "
                             f"{mesh.shape}")
    x = torch.arange(12, dtype=torch.int64, device=device).view(3, 4)
    checks = {"all_gather": mesh_mod.all_gather(mesh, x)[0],
              "all_reduce sum": mesh_mod.all_reduce(mesh, x, "sum"),
              "all_reduce max": mesh_mod.all_reduce(mesh, x, "max"),
              "exchange": mesh_mod.exchange(mesh, x, [0])}
    for label, got in checks.items():
        if got.device != x.device or not torch.equal(got, x):
            raise AssertionError(f"NCCL {label} on {got.device}: differs")
    table = ShardedGeneratorTable.from_rows(rows, mesh)
    one = ms.GeneratorTable.from_rows(rows, device)
    dig = torch.from_numpy(digits).to(device)
    got = table.msm_digits_enc_finish(table.msm_digits_enc_launch(dig))
    want = one.msm_digits_enc_finish(one.msm_digits_enc_launch(dig))
    if got != want:
        raise AssertionError("NCCL D = 1: the sharded table's commitment "
                             "encodings differ from GeneratorTable's")
    ws, _ = ms.window_sums_t(table.local(dig), table.src,
                             len(table.cols_host))
    return {"collectives": sorted(checks),
            "point_sum": check_point_sum(
                ms, mesh_mod.all_gather(mesh, ws),
                "NCCL D = 1 gathered example commitment window sums")}


def mesh_phase(pins, direct, ex_call, smi):
    """Phase 13: the sharded path over torch.distributed on the one card.
    (a), (b): the gloo worlds of MESH_WORLDS, every rank on cuda:0, their
    window sums and collectives through the host; (c) NCCL at world size
    one.  Returns the launches of (a) and (b), summed over ranks."""
    from bulletproof_gadgets_tpu_torch.parallel import distributed
    total = {}
    # the ranks keep their generators apart from this process's cache
    # (phase 12's 2^20 generators), in a git-ignored directory of the
    # checkout
    cache = os.environ.get("BPG_TORCH_CACHE")
    os.environ["BPG_TORCH_CACHE"] = os.path.join(
        ROOT, "bulletproof_gadgets_tpu_torch", "_cache", "ranks")
    store = os.path.join(os.environ["BPG_TORCH_CACHE"],
                         f"rendezvous-{os.getpid()}")
    os.makedirs(os.environ["BPG_TORCH_CACHE"], exist_ok=True)
    try:
        for world, names in MESH_WORLDS:
            t0 = time.time()
            ranks = distributed.run_ranks(
                mesh_rank, world, f"{store}-{world}",
                args=(names, "cuda:0", PINS), backend="gloo",
                timeout=MESH_LIMIT)
            for name in names:
                for r, res in enumerate(ranks):
                    (p1, v1), (p2, v2) = res["statements"][name]["times"]
                    say(f"mesh {world} ranks over gloo on one card, rank {r}:"
                        f" {name} proof and .coms equal the pins, verify "
                        f"true, tampered false; prove first {p1:.2f} s warm "
                        f"{p2:.2f} s, verify first {v1:.2f} s warm {v2:.2f} "
                        f"s (one device, phase 4, warm: prove "
                        f"{direct[name][0]:.2f} s, verify "
                        f"{direct[name][1]:.2f} s; the ranks share the "
                        f"card), {smi}")
                    for k, v in res["statements"][name]["launches"].items():
                        total[k] = total.get(k, 0) + v
                say(f"mesh {world} ranks, {name}: launches per rank "
                    f"{[res['statements'][name]['launches'] for res in ranks]}"
                    "; collectives of rank 0's warm prove [calls, bytes it "
                    f"put in]: {ranks[0]['statements'][name]['traffic']}")
            err, k_ms, p_ms, b_ms, b_by = ranks[0]["point_sum"]
            say(f"mesh {world} ranks: K7 on the ranks' example commitment "
                f"window sums equal to plain (max abs err {err}), {k_ms:.4f}"
                f" ms vs plain {p_ms:.3f} ms, bound {b_ms:.4g} ms ({b_by}); "
                f"{time.time() - t0:.1f} s from spawn to results; {smi}")
        t0 = time.time()
        digits, src, _ = ex_call
        (res,) = distributed.run_ranks(
            nccl_rank, 1, f"{store}-nccl",
            args=("cuda:0", src.cpu().numpy(), digits.cpu().numpy()),
            backend="nccl", timeout=MESH_LIMIT)
        err, k_ms, p_ms, _, _ = res["point_sum"]
        say(f"mesh NCCL world of one on cuda:0: {', '.join(res['collectives'])}"
            " equal on CUDA tensors; a ShardedGeneratorTable at D = 1 gives "
            "GeneratorTable's example commitment encodings; K7 on its "
            f"gathered window sums equal to plain (max abs err {err}), "
            f"{k_ms:.4f} ms vs plain {p_ms:.3f} ms; {time.time() - t0:.1f} s;"
            f" {smi}")
    finally:
        if cache is None:
            del os.environ["BPG_TORCH_CACHE"]
        else:
            os.environ["BPG_TORCH_CACHE"] = cache
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bulletproof_gadgets_tpu_torch import native
    from bulletproof_gadgets_tpu_torch.core import r1cs
    from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
    from bulletproof_gadgets_tpu_torch.core.msm import msm_host
    from bulletproof_gadgets_tpu_torch.core.scalar import L
    from bulletproof_gadgets_tpu_torch.lang.prove import prove
    from bulletproof_gadgets_tpu_torch.lang.verify import verify
    from bulletproof_gadgets_tpu_torch.ops import (
        engine, ipa_fold, ipa_fused, msm_serial as ms,
        ristretto_device as rd, strobe_device as sd)
    from bulletproof_gadgets_tpu_torch.utils import rng as blind_rng

    with open(PINS) as f:
        pins = json.load(f)
    device = engine.register("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_start = time.time()
    marks = [t_start]

    def phase_done(label):
        now = time.time()
        say(f"phase {label}: {now - marks[0]:.1f} s")
        marks[0] = now

    # 1. build
    t0 = time.time()
    path = native.build()
    native.load()
    say(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s "
        f"for {smi}")
    for line in native.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            say(f"  ptxas: {line.strip()}")

    phase_done(1)

    # 2. kernels against their plain versions on the example's own MSMs
    #    and its fold
    ex = pins["statements"]["example"]
    calls, folds = [], []
    msm_digits_t, ladder_fold = ms.msm_digits_t, ipa_fold.ladder_fold

    def record(digits, src, n, *a, **kw):
        calls.append((digits, src, n))
        return msm_digits_t(digits, src, n, *a, **kw)

    def record_fold(src, base, dig):
        folds.append((src, base, dig))
        return ladder_fold(src, base, dig)

    t0 = time.time()
    ms.msm_digits_t, ipa_fold.ladder_fold = record, record_fold
    try:
        blind_rng.set_seed(pins["seed"])
        coms = []
        proof, _ = prove("example", ex["instance"], ex["witness"],
                         ex["gadgets"], coms)
        ok = verify("example", ex["instance"], proof, "".join(coms),
                    ex["gadgets"])
    finally:
        ms.msm_digits_t, ipa_fold.ladder_fold = msm_digits_t, ladder_fold
        blind_rng.set_seed(None)
    ks = [d.shape[0] // ms.W for d, _, _ in calls]
    if not ok or ks[0] != 3 or ks[-1] != 1 or len(folds) != 1:
        raise AssertionError(f"example: verify {ok}, first/last table MSM "
                             f"k={ks[0]}/{ks[-1]}, want 3/1, {len(folds)} "
                             "folds, want 1")
    say(f"example: {len(calls)} table MSMs ({calls[0][2]} points on "
        f"{device}) and one fold recorded from one prove + verify in "
        f"{time.time() - t0:.1f} s")
    results = check_kernels(ms, *calls[0], "k=3 commitment launch")
    verifier = check_kernels(ms, *calls[-1], "k=1 verifier launch")
    check_edge_kernels(ms, device)
    for name, kernel in (("K1", "bucket_accumulate_kernelILb0E"),
                         ("K2", "bucket_accumulate_kernelILb1E"),
                         ("K8/K10", "bucket_accumulate_limbs_kernelILb0E"),
                         ("K9", "bucket_accumulate_limbs_kernelILb1E"),
                         ("K3", "bucket_merge_kernel"),
                         ("K4", "window_sums_kernel"),
                         ("K5", "horner_kernel"),
                         ("K6", "ladder_fold_kernel"),
                         ("K7", "point_sum_kernel"),
                         ("compression", "ristretto_compress_kernel"),
                         ("transcript", "transcript_round_kernel")):
        say(f"ptxas {name} {kernel}: {ptxas_usage(native.BUILD_LOG, kernel)}")
    for label, res in (("k=3 commitment", results),
                       ("k=1 verifier", verifier)):
        k1 = res["bucket_accumulate"][1]
        say(f"on the example's {label} launch: K3 "
            f"{res['bucket_merge'][1] / k1:.3f}x K1, K4 "
            f"{res['window_sums'][1] / k1:.3f}x K1, K5 "
            f"{res['horner'][1] / k1:.3f}x K1 (K1 {k1:.3f} ms)")
    results["ladder_fold"] = check_fold(ipa_fold, *folds[0], "example fold")
    ex_call = calls[0]                           # phase 9's example launch
    del calls[:], folds[:]

    phase_done(2)

    # 3. whole MSMs against the host Pippenger
    pts = list(BulletproofGens(1024, device=device).G(1024))
    src = torch.from_numpy(ms.prep_source(pts)).to(device)
    r = random.Random(3)
    cases = {"k=1 random": ([[r.randrange(L) for _ in range(1024)]], None),
             "k=3 bits/zeros/>=L, point chunks of 256": (
                 [[r.randrange(2) for _ in range(1024)], [0] * 1024,
                  [r.randrange(L, 4 * L) for _ in range(1024)]], 256),
             "k=2 concentrated (one scalar repeated, all ones: every "
             "window's digits equal)": (
                 [[r.randrange(L)] * 1024, [1] * 1024], None)}
    for label, (vecs, chunk) in cases.items():
        digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                                 for vec in vecs], axis=1)
        d = torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))
        s = ms.schedule(d.to(device)[:, :chunk or 1024], 1024)
        if int(s.used) > s.pool:
            raise AssertionError(f"MSM n=1024 {label}: pool {int(s.used)} "
                                 f"> P {s.pool}")
        got = ms.points_from_cols(*ms.msm_digits_t(d.to(device), src, 1024,
                                                   chunk))
        want = [msm_host(v, pts) for v in vecs]
        if [g.compress() for g in got] != [w.compress() for w in want]:
            raise AssertionError(f"MSM n=1024 {label}: differs from msm_host")
        say(f"msm n=1024 {label}: equal to msm_host; first chunk's pool "
            f"{int(s.used)} <= P {s.pool}")

    phase_done(3)

    # 4. the main path: prove and verify the pinned statements
    ipa_runs = []                                # [n, folds] per argument
    host_calls = {}                              # host loops the path ran
    fused_create, materialize = ipa_fused.create, ipa_fold.materialize
    point_sum = ms.point_sum
    combines, chunked = [], [0]                  # merkle32's K7 inputs
    m_folds = []                                 # merkle32's K6 inputs
    compress, t_round = rd.ristretto_compress, sd.transcript_round
    rec = {}                  # merkle32's warm inputs of the new kernels
    syncs = {}                # synchronizing calls of a warm argument
    direct = {}               # warm (prove s, verify s) per statement

    def count_ipa(transcript, table, w, G_factors, *a, **kw):
        ipa_runs.append([len(G_factors), 0])
        if name == "merkle32" and times:         # the warm prove
            out, syncs[name] = counted_syncs(
                torch, ipa_fused, fused_create, transcript, table, w,
                G_factors, *a, **kw)
            return out
        return fused_create(transcript, table, w, G_factors, *a, **kw)

    def count_fold(*a):
        ipa_runs[-1][1] += 1
        return materialize(*a)

    def record_chunks(digits, src, n, *a, **kw):
        chunked[0] += n > ms.POINT_CHUNK
        if not calls and n > ms.POINT_CHUNK:
            calls.append((digits, src, n))       # the commitment MSM
        return msm_digits_t(digits, src, n, *a, **kw)

    def record_fold4(src, base, dig):
        if name == "merkle32" and not m_folds:
            m_folds.append((src, base, dig))
        return ladder_fold(src, base, dig)

    def record_sum(ws):
        if not combines:
            combines.append(ws)
        return point_sum(ws)

    def record_compress(cols):
        if name == "merkle32":
            rec["commitments" if cols.shape[2] == 3 else "round"] = cols
        return compress(cols)

    def record_round(state, meta, enc):
        if name == "merkle32":
            rec["transcript"] = (state, meta, enc)
        return t_round(state, meta, enc)

    def host_spy(name, fn):
        def spy(*a, **kw):
            host_calls[name] = host_calls.get(name, 0) + 1
            return fn(*a, **kw)
        return spy
    hosts = [(r1cs.Prover, "_flattened_constraints"),
             (r1cs.Verifier, "_flattened_constraints"), (r1cs, "exp_iter"),
             (ms, "signed_digits")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in hosts]
    for obj, name, fn in saved:
        setattr(obj, name, host_spy(f"{getattr(obj, '__name__', obj)}."
                                    f"{name}", fn))
    ipa_fused.create, ipa_fold.materialize = count_ipa, count_fold
    ipa_fold.ladder_fold = record_fold4
    ms.msm_digits_t, ms.point_sum = record_chunks, record_sum
    rd.ristretto_compress, sd.transcript_round = record_compress, record_round
    for name in ms.LAUNCHES:
        ms.LAUNCHES[name] = 0
    try:
        for name in ("bound16", "less_than", "example", "merkle32"):
            st = pins["statements"][name]
            times = []
            chunked[0] = 0
            for _ in range(2):                   # first, then warm
                blind_rng.set_seed(pins["seed"])
                coms = []
                del ipa_runs[:]
                host_calls.clear()
                t0 = time.time()
                proof, _ = prove(name, st["instance"], st["witness"],
                                 st["gadgets"], coms)
                t_prove = time.time() - t0
                if ipa_runs != IPA_RUNS[name]:
                    raise AssertionError(
                        f"{name}: device IPA runs [n, folds] {ipa_runs}, "
                        f"want {IPA_RUNS[name]}")
                coms = "".join(coms)
                if (hashlib.sha256(proof).hexdigest() != st["proof_sha256"]
                        or hashlib.sha256(coms.encode()).hexdigest()
                        != st["coms_sha256"]):
                    raise AssertionError(f"{name}: proof or .coms differ "
                                         "from the JAX package's pin")
                t0 = time.time()
                ok = verify(name, st["instance"], proof, coms, st["gadgets"])
                t_verify = time.time() - t0
                if not ok:
                    raise AssertionError(f"{name}: verify returned false")
                if name in ("example", "merkle32") and host_calls:
                    raise AssertionError(f"{name}: host loops ran on the "
                                         f"device path: {host_calls}")
                times.append((t_prove, t_verify))
            direct[name] = times[1]
            bad = bytearray(proof)
            bad[len(bad) // 2] ^= 1
            if verify(name, st["instance"], bytes(bad), coms, st["gadgets"]):
                raise AssertionError(f"{name}: tampered proof verified")
            blind_rng.set_seed(None)
            say(f"statement {name} ({st['multipliers']} multipliers, "
                f"{st['gens']} gens): proof and .coms equal the pins, verify "
                f"true, tampered false, device IPA runs [n, folds] "
                f"{ipa_runs}, {chunked[0]} chunked table MSMs in 2 prove + "
                f"3 verify, host loops {host_calls or 'none'}; prove first "
                f"{times[0][0]:.2f} s warm {times[1][0]:.2f} s, verify first "
                f"{times[0][1]:.2f} s warm {times[1][1]:.2f} s")
        launches = dict(ms.LAUNCHES)
    finally:
        ipa_fused.create, ipa_fold.materialize = fused_create, materialize
        ipa_fold.ladder_fold = ladder_fold
        ms.msm_digits_t, ms.point_sum = msm_digits_t, point_sum
        rd.ristretto_compress, sd.transcript_round = compress, t_round
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    if chunked[0] == 0 or launches["point_sum"] != chunked[0]:
        raise AssertionError(f"merkle32: {chunked[0]} chunked MSMs, "
                             f"{launches['point_sum']} K7 launches (want "
                             "one per chunked MSM)")
    idle = [k for k in KERNELS
            if launches[k] == 0 and k != "bucket_accumulate_cont"
            and k not in OTHER_LAYOUTS]
    if idle:
        raise AssertionError(f"kernels not launched by the main path: {idle}")
    say(f"main path launches: {launches}")
    if syncs.get("merkle32", {}).get("rounds", 1) or \
            syncs["merkle32"]["finish"] < 1:
        raise AssertionError(f"warm merkle32 argument: synchronizing calls "
                             f"{syncs}, want none in its round loop")
    say(f"warm merkle32 ipa_fused.create (16 rounds) under the sync debug "
        f"mode: {syncs['merkle32']['before']} synchronizing calls before "
        f"its round loop, {syncs['merkle32']['rounds']} in it, "
        f"{syncs['merkle32']['finish']} in its final readback")

    phase_done(4)

    # 5. K7 on merkle32's chunk combine and on a wide launch; K1 per entry
    #    with and without point chunks on merkle32's commitment MSM; K6 on
    #    merkle32's fold
    check_fold(ipa_fold, *m_folds[0], "merkle32 fold")
    results["point_sum"] = check_point_sum(ms, combines[0],
                                           "merkle32 commitment combine")
    m_digits, m_src, m_n = calls[0]
    wide = 1 << 17
    lanes = torch.arange(wide + 1, dtype=torch.int32, device=device)
    p = ms.bucket_accumulate(m_src, lanes[None, :wide].contiguous())
    q = ms.bucket_accumulate(m_src, lanes[None, 1:].contiguous())
    check_point_sum(ms, torch.stack([p, q]), "2^17 lanes of table points")
    d17_msm(ms, rd, m_digits, m_src, m_n)
    launch_floor(ms, device)
    m32_ns = None
    for chunk in (ms.POINT_CHUNK >> 1, ms.POINT_CHUNK, 2 * ms.POINT_CHUNK):
        ns, total, entries = k1_per_entry(ms, m_digits, m_src, m_n, chunk)
        m32_ns = ns if chunk == ms.POINT_CHUNK else m32_ns
        say(f"K1 on merkle32's k=3 commitment MSM ({m_n} points) in chunks "
            f"of {chunk} points ({-(-m_n // chunk)} chunks): {entries} "
            f"entries, {total:.3f} ms, {ns:.3f} ns per entry")

    phase_done(5)

    # 6. the batch path; 7. K2 and the round chunks; 8. ms per witness
    batch_launches, k2_in, stacked, rows_batch = batch_path(pins, ms)
    s_digits, s_src, s_n = stacked               # K3, K4 and K5 at k = 9
    check_kernels(ms, s_digits[:, :ms.POINT_CHUNK], s_src, s_n,
                  "merkle32 x 3 stacked k=9 launch, first point chunk",
                  only=("bucket_merge", "window_sums", "horner"))
    results["bucket_accumulate_cont"] = check_cont(ms, *k2_in)
    round_chunk_times(ms, *stacked)
    bound64_per_witness(device)

    phase_done("6-8")

    # 9. the pre-transposed layouts: kernels, layout times, the main path
    results.update(check_layout_kernels(ms, ex_call, k2_in))
    for label, l_src, l_idx, l_acc in (
            ("the example's k=3 launch", ex_call[1],
             ms.plan(ex_call[0], ex_call[2])[0], None),
            ("merkle32's k=3 commitment chunk (2^17 points)", m_src,
             ms.plan(m_digits[:, :ms.POINT_CHUNK], m_n, 0)[0], None),
            ("the merkle32 x 3 round chunk", *k2_in)):
        layout_times(ms, label, l_src, l_idx, l_acc)
    for label, call in (("the example's k=3 launch", ex_call),
                        ("merkle32's k=3 commitments", (m_digits, m_src, m_n)),
                        ("merkle32 x 3's stacked commitments", stacked)):
        layout_msm_times(ms, label, *call)
    layout_launches = [layout_path(pins, ms, engine, layout,
                                   rows_batch["merkle32"])
                       for layout in ("cols", "flat")]

    phase_done(9)

    # 10. the device transcript's kernels against their plain versions
    results.update(check_transcript_kernels(rd, sd, rec, device))

    phase_done(10)

    # 11. the embedding surfaces: HTTP, C ABI, JNI; the host transcript
    surface_launches = surfaces(pins, ms, engine, direct)
    phase_done(11)

    # 12. the 2^20-gens 512-leaf stress circuit
    stress_launches = stress_phase(pins, ms, m32_ns)
    phase_done(12)

    # 13. the sharded path: gloo ranks on the one card, NCCL at world size 1
    mesh_launches = mesh_phase(pins, direct, ex_call, smi)
    phase_done(13)

    say(f"all phases in {time.time() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_file,
         "replaces": replaces,
         "launches": launches[name] + batch_launches[name]
         + sum(run[name] for run in layout_launches)
         + surface_launches[name] + stress_launches.get(name, 0)
         + mesh_launches.get(name, 0),
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
