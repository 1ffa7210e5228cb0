"""Commitment helpers (reference src/commitments.rs public API).

SDK-path sugar over Prover.commit / Verifier.commit: multi-limb witnesses
are split via be_to_scalars (32-byte LE limbs, inverted block order) and
committed with fresh random blindings.
"""

from ..utils.conversions import be_to_scalar, be_to_scalars
from ..utils import rng


def commit(prover, witness: bytes):
    """Variable-length witness -> (scalars, commitments, variables); splits
    into multiple commitments beyond 32 bytes (commitments.rs:35-44)."""
    scalars = be_to_scalars(witness)
    commitments, variables = [], []
    for scalar in scalars:
        com, var = prover.commit(scalar, rng.random_scalar())
        commitments.append(com)
        variables.append(var)
    return scalars, commitments, variables


def commit_single(prover, witness: bytes):
    """<=32-byte witness -> (scalar, commitment, variable)
    (commitments.rs:23-31)."""
    assert len(witness) <= 32, "the provided witness is longer than 32 bytes"
    scalar = be_to_scalar(witness)
    com, var = prover.commit(scalar, rng.random_scalar())
    return scalar, com, var


def commit_all_single(prover, witnesses):
    """Many <=32-byte witnesses (commitments.rs:9-20)."""
    scalars, commitments, variables = [], [], []
    for witness in witnesses:
        s, c, v = commit_single(prover, witness)
        scalars.append(s)
        commitments.append(c)
        variables.append(v)
    return scalars, commitments, variables


def verifier_commit(verifier, commitments):
    """Compressed commitment bytes -> verifier variables
    (commitments.rs:46-48)."""
    return [verifier.commit(com) for com in commitments]
