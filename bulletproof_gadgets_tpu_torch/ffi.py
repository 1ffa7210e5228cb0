"""Python half of the C ABI surface (capi/bpg_ffi.c).

Mirrors the reference's FFI marshalling contract
(interfaces/ios/src/lib.rs:11-52 and interfaces/android/src/lib.rs:84-108
of the reference): inputs are the statement name plus the raw text of the
.inst/.wtns/.gadgets files (and .coms + proof bytes on the verify side);
outputs are the .coms text and serialized proof bytes.

The device comes from BPG_TORCH_DEVICE when it is set, else it is the one
registered before with ops.engine.register, else CUDA (ops.engine.use).
"""
import os

from .core.r1cs import R1CSError
from .core.transcript import ProofError
from .lang.prove import prove as _prove
from .lang.verify import verify as _verify


def ffi_prove(name: str, instance: str, witness: str, gadgets: str):
    """Returns (commitments_text, proof_bytes)."""
    coms: list = []
    proof, _num_constraints = _prove(name, instance, witness, gadgets, coms,
                                     device=os.environ.get("BPG_TORCH_DEVICE"))
    return "".join(coms), bytes(proof)


def ffi_verify(name: str, instance: str, proof: bytes, commitments: str,
               gadgets: str) -> bool:
    try:
        return bool(_verify(name, instance, proof, commitments, gadgets,
                            device=os.environ.get("BPG_TORCH_DEVICE")))
    except (ProofError, R1CSError, ValueError, KeyError):
        # bad input surfaces as False (reference verify.rs:71-72 maps proof
        # errors to Ok(false)): a proof that does not parse, gadgets or
        # assignments that do not parse (lang.parser.ParseError is a
        # ValueError), a missing variable or commitment.  Anything else (a
        # kernel that does not build or launch) propagates: the C side
        # prints it and returns 0, and no failure passes as a rejection.
        return False
