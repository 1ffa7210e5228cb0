"""Verifier CLI (reference src/bin/verifier.rs).

Usage: python -m bulletproof_gadgets_tpu_torch.cli.verifier <name>
Reads <name>.inst, <name>.coms, <name>.proof, <name>.gadgets; prints
true/false.

The device comes from BPG_TORCH_DEVICE (default "cuda"); asking for CUDA
where it is not available raises.
"""
import os
import sys

INSTANCE_VARS_EXT = ".inst"
COMMITMENTS_EXT = ".coms"
GADGETS_EXT = ".gadgets"
PROOF_EXT = ".proof"


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("missing argument", file=sys.stderr)
        return 1
    filename = argv[0]

    from ..lang.verify import verify

    with open(filename + INSTANCE_VARS_EXT) as f:
        instance = f.read()
    with open(filename + COMMITMENTS_EXT) as f:
        commitments = f.read()
    with open(filename + PROOF_EXT, "rb") as f:
        proof = f.read()
    with open(filename + GADGETS_EXT) as f:
        gadgets = f.read()

    verified = verify(filename, instance, proof, commitments, gadgets,
                      device=os.environ.get("BPG_TORCH_DEVICE", "cuda"))
    print("true" if verified else "false")
    return 0


if __name__ == "__main__":
    sys.exit(main())
