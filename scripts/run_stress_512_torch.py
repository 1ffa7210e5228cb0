"""The 2^20-gens 512-leaf MiMC Merkle stress circuit (reference
merkle_tree_gadget.rs:474, #[ignore]d there) on one GPU: the PyTorch port's
counterpart of scripts/run_stress_512.py, with the same statement driven
the same way through `Prover.prove_gen`.

    python3 scripts/run_stress_512_torch.py [--leaves 512] [--layout rows]

The statement: 512 copies of the leaf MW1 committed one by one
(`commit_all_single`) under the transcript label b"MerkleTree", and a
`Hash(W, W)` pattern nested 8 times (a depth-9 tree of MiMC sponges) whose
root is the instance; the generators are BulletproofGens(2048 * leaves),
2^20 for 512 leaves (a [G | H | B | B_blinding] table of 2^21 + 2 points:
17 point chunks of the MSM).  Seed "stress-512" for the blindings.  The
prover's requests are answered as core/r1cs.Prover.prove answers them, on
a GeneratorTable on the GPU in the given MSM layout; then the proof is
verified, and a copy with one byte flipped must be rejected.

Prints one line per phase with its seconds (generators, commitments,
assembly, table build and upload, each prove request, verifier assembly,
verify, the tampered verify), the constraint and multiplier counts (the
JAX package's record at 512 leaves: 1,986,769 and 993,384), the host peak
RSS and the device's peak allocated memory, and exits non-zero if any
check fails.  `--leaves` is a power of two of at least 2 (`merkle_tree4`
in tests/port_pins.json is the 4-leaf statement).
"""
import argparse
import copy
import hashlib
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = "stress-512"
LABEL = b"MerkleTree"
MW1 = "0522a64d7b931e21760cf955a15fcc793e8a52b42a56ab03afddec8beb668749"
# the 512-leaf root of the JAX package's run_stress_512.py
ROOT_512 = "038c137beec8e2edfb5c48cbd063f04e569139d2221a4eb7befb85aa1bf8ba40"
# the JAX package's record at 512 leaves (docs/STATUS_r4.md)
RECORD_512 = {"constraints": 1986769, "multipliers": 993384}
GENS_PER_LEAF = 2048        # BulletproofGens(1048576) at 512 leaves


def pattern(leaves: int):
    """Hash(W, W) nested log2(leaves) - 1 times."""
    from bulletproof_gadgets_tpu_torch.models.merkle_tree import Hash, W
    if leaves < 2 or leaves & (leaves - 1):
        raise ValueError(f"--leaves {leaves}: a power of two >= 2")
    pat = Hash(W, W)
    for _ in range(leaves.bit_length() - 2):
        pat = Hash(pat, pat)
    return pat


def root_of(leaves: int) -> int:
    """The tree's root: every leaf is MW1, so each level's nodes are one
    MiMC sponge of two copies of the level below."""
    from bulletproof_gadgets_tpu_torch.models.mimc import mimc_sponge
    from bulletproof_gadgets_tpu_torch.utils.conversions import be_to_scalar
    node = be_to_scalar(bytes.fromhex(MW1)).v
    for _ in range(leaves.bit_length() - 1):
        node = mimc_sponge([node, node])
    return node


def run(leaves: int = 512, layout: str = "rows", device="cuda",
        mark=None) -> dict:
    """Prove and verify the statement at `leaves` leaves on `device`
    (registered with ops/engine in `layout`).  mark(tag, seconds) is
    called after each phase.  Returns the proof and .coms bytes, the
    counts, verify / tampered results, each phase's seconds, the host
    peak RSS (GB), the device's peak allocated bytes (None on the CPU) and
    the kernel launches of prove and verify."""
    import torch
    from bulletproof_gadgets_tpu_torch import native
    from bulletproof_gadgets_tpu_torch.core.commitments import (
        commit_all_single, verifier_commit)
    from bulletproof_gadgets_tpu_torch.core.gens import (BulletproofGens,
                                                         PedersenGens)
    from bulletproof_gadgets_tpu_torch.core.lc import to_lc
    from bulletproof_gadgets_tpu_torch.core.msm import generator_table
    from bulletproof_gadgets_tpu_torch.core.proof import R1CSProof
    from bulletproof_gadgets_tpu_torch.core.r1cs import (Prover, R1CSError,
                                                         Verifier,
                                                         _next_pow2)
    from bulletproof_gadgets_tpu_torch.core.transcript import ProofError
    from bulletproof_gadgets_tpu_torch.models.merkle_tree import MerkleTree256
    from bulletproof_gadgets_tpu_torch.ops import engine, ipa_fused
    from bulletproof_gadgets_tpu_torch.utils import rng
    from bulletproof_gadgets_tpu_torch.utils.merlin import new_transcript

    dev = engine.register(device, msm_layout=layout)
    seconds = {}
    clock = [time.time()]

    def phase(tag):
        now = time.time()
        seconds[tag] = now - clock[0]
        clock[0] = now
        if mark is not None:
            mark(tag, seconds[tag])

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pat = pattern(leaves)
    root_int = root_of(leaves)
    if leaves == 512 and root_int != int.from_bytes(bytes.fromhex(ROOT_512),
                                                    "big"):
        raise AssertionError("the 512-leaf root differs from the record's")
    root = to_lc(root_int)
    witnesses = [bytes.fromhex(MW1)] * leaves
    rng.set_seed(SEED)
    try:
        pc = PedersenGens.default()
        bp = BulletproofGens(GENS_PER_LEAF * leaves, 1, device=dev)
        phase("generators")
        prover = Prover(pc, new_transcript(LABEL))
        _, coms, variables = commit_all_single(prover, witnesses)
        phase(f"{leaves} witness commits")
        MerkleTree256(root, [], [v.lc() for v in variables],
                      pat).prove(prover, [], [])
        counts = {"constraints": prover.num_constraints(),
                  "multipliers": prover.get_num_multiplications()}
        phase(f"assembly ({counts['constraints']} constraints, "
              f"{counts['multipliers']} multipliers)")
        padded = _next_pow2(counts["multipliers"])
        table = generator_table(bp.G(padded), bp.H(padded), pc.B,
                                pc.B_blinding)      # prove_gen's, cached
        if dev.type == "cuda":
            torch.cuda.synchronize()
        phase(f"table build and upload ({table.m} points)")
        for name in native.LAUNCHES:
            native.LAUNCHES[name] = 0
        gen = prover.prove_gen(bp)
        resp, i = None, 0
        while True:
            try:
                kind, table, arg = gen.send(resp)
            except StopIteration as stop:
                proof = stop.value
                break
            if kind == "msm":
                resp = table.msm_digits(arg)
            elif kind == "msm_enc":
                resp = table.msm_digits_enc_finish(
                    table.msm_digits_enc_launch(arg))
            elif kind == "fused_ipa":
                resp = ipa_fused.create(arg[0], table, *arg[1:])
            else:
                resp = arg.cpu()
            phase(f"prove request {i}: {kind}")
            i += 1
        proof_bytes = proof.to_bytes()
        phase("prove (the rest)")
        verifier = Verifier(new_transcript(LABEL))
        w_vars = verifier_commit(verifier, coms)
        MerkleTree256(root, [], [v.lc() for v in w_vars],
                      pat).verify(verifier, w_vars, [])
        phase("verifier assembly")
        # the tampered copy's verifier: the same constraints, a transcript
        # at the same state (verify consumes only the transcript)
        spare = copy.copy(verifier)
        spare.transcript = new_transcript(LABEL)
        spare.transcript.set_strobe_state(
            *verifier.transcript.strobe_state())
        try:
            verifier.verify(R1CSProof.from_bytes(proof_bytes), pc, bp)
            ok = True
        except (R1CSError, ProofError):
            ok = False
        phase("verify")
        launches = dict(native.LAUNCHES)
        bad = bytearray(proof_bytes)
        bad[len(bad) // 2] ^= 1
        try:
            spare.verify(R1CSProof.from_bytes(bytes(bad)), pc, bp)
            tampered = True
        except (R1CSError, ProofError):
            tampered = False
        phase("tampered verify")
    finally:
        rng.set_seed(None)
    return {"leaves": leaves, "layout": layout, "proof": proof_bytes,
            "coms": b"".join(coms), **counts,
            "verify": ok, "tampered_verifies": tampered,
            "seconds": seconds, "launches": launches,
            "rss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1e6,
            "device_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if dev.type == "cuda" else None)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leaves", type=int, default=512)
    ap.add_argument("--layout", choices=("rows", "cols"), default="rows")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("run_stress_512_torch: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t0 = time.time()

    def mark(tag, s):
        print(f"[{time.time() - t0:8.1f}s] {tag}: {s:.2f} s", flush=True)
    res = run(args.leaves, args.layout, "cuda", mark)
    print(f"{args.leaves}-leaf Merkle ({GENS_PER_LEAF * args.leaves} gens, "
          f"{args.layout}): {res['constraints']} constraints, "
          f"{res['multipliers']} multipliers; verify {res['verify']}, "
          f"tampered verifies {res['tampered_verifies']}; proof sha256 "
          f"{hashlib.sha256(res['proof']).hexdigest()}; host peak RSS "
          f"{res['rss_gb']:.2f} GB; device peak "
          f"{res['device_peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in res['launches'].items() if v} }",
          flush=True)
    if args.leaves == 512 and any(res[k] != v for k, v in
                                  RECORD_512.items()):
        print(f"counts differ from the JAX record {RECORD_512}",
              file=sys.stderr)
        return 1
    return 0 if res["verify"] and not res["tampered_verifies"] else 1


if __name__ == "__main__":
    sys.exit(main())
