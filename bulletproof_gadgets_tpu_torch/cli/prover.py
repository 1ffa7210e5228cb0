"""Prover CLI (reference src/bin/prover.rs).

Usage: python -m bulletproof_gadgets_tpu_torch.cli.prover <name>
Reads <name>.inst, <name>.wtns, <name>.gadgets; writes <name>.coms and
<name>.proof; prints the constraint count (prove.rs:75).

The device comes from BPG_TORCH_DEVICE (default "cuda"); asking for CUDA
where it is not available raises.
"""
import os
import sys

INSTANCE_VARS_EXT = ".inst"
WITNESS_VARS_EXT = ".wtns"
COMMITMENTS_EXT = ".coms"
GADGETS_EXT = ".gadgets"
PROOF_EXT = ".proof"


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("missing argument", file=sys.stderr)
        return 1
    filename = argv[0]

    from ..ops import engine
    engine.register(os.environ.get("BPG_TORCH_DEVICE", "cuda"))

    from ..lang.prove import prove

    with open(filename + INSTANCE_VARS_EXT) as f:
        instance = f.read()
    with open(filename + WITNESS_VARS_EXT) as f:
        witness = f.read()
    with open(filename + GADGETS_EXT) as f:
        gadgets = f.read()

    coms: list = []
    proof, num_constraints = prove(filename, instance, witness, gadgets, coms)
    print(num_constraints)

    with open(filename + COMMITMENTS_EXT, "w") as f:
        f.write("".join(coms))
    with open(filename + PROOF_EXT, "wb") as f:
        f.write(proof)
    return 0


if __name__ == "__main__":
    sys.exit(main())
