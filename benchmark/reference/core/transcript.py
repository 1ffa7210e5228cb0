"""Bulletproofs TranscriptProtocol: the label conventions the dalek crate
layers over Merlin (bulletproofs::transcript).  Byte-for-byte equivalent."""

from ..utils.merlin import Transcript
from .scalar import Scalar
from .ristretto import IDENTITY_COMPRESSED


class ProofError(Exception):
    pass


def r1cs_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs v1")


def r1cs_1phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-1phase")


def r1cs_2phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-2phase")


def innerproduct_domain_sep(t: Transcript, n: int) -> None:
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)


def append_scalar(t: Transcript, label: bytes, s: Scalar) -> None:
    t.append_message(label, s.as_bytes())


def append_point(t: Transcript, label: bytes, compressed: bytes) -> None:
    t.append_message(label, compressed)


def validate_and_append_point(t: Transcript, label: bytes,
                              compressed: bytes) -> None:
    if compressed == IDENTITY_COMPRESSED:
        raise ProofError("point is the identity")
    t.append_message(label, compressed)


def challenge_scalar(t: Transcript, label: bytes) -> Scalar:
    return Scalar.from_bytes_mod_order_wide(t.challenge_bytes(label, 64))
