"""Merlin transcripts (STROBE-128 over Keccak-f[1600]), byte-for-byte
compatible with the `merlin` crate v2.0.1 used by the reference
(reference Cargo.toml:11; transcript creation reference src/prove.rs:45).

Every Fiat-Shamir challenge in the proof system flows through this object, so
it must match the Rust implementation exactly; tests/test_merlin.py pins the
published merlin "equivalence" test vector.
"""

from ..capi import NativeTranscript
from .keccak import f1600_bytes

STROBE_R = 166

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Strobe128:
    """Minimal STROBE-128 duplex as implemented in merlin::strobe."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        state = bytearray(200)
        state[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        state[6:18] = b"STROBEv1.0.2"
        f1600_bytes(state)
        self.state = state
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internal duplex plumbing -----------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError(
                    "continued op with different flags: %r != %r"
                    % (flags, self.cur_flags))
            return
        if flags & _FLAG_T:
            raise ValueError("transport flag not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops used by merlin ----------------------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        # KEY overwrites state bytes rather than xoring them.
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()


def _encode_u32(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript equivalent."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_encode_u32(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_encode_u32(n), True)
        return self.strobe.prf(n, False)

    def strobe_state(self):
        """(200 state bytes, pos, pos_begin, cur_flags)."""
        s = self.strobe
        return bytes(s.state), s.pos, s.pos_begin, s.cur_flags

    def set_strobe_state(self, state: bytes, pos: int, pos_begin: int,
                         cur_flags: int) -> None:
        """Overwrite the STROBE state and positions (a state carried on
        elsewhere, e.g. by the device transcript, written back)."""
        if len(state) != 200:
            raise ValueError(f"state of {len(state)} bytes, expected 200")
        s = self.strobe
        s.state = bytearray(state)
        s.pos, s.pos_begin, s.cur_flags = pos, pos_begin, cur_flags


def new_transcript(label: bytes):
    """The transcript of lang.prove / lang.verify: the C one
    (capi/merlin_native.c, built at first use; a failed build raises).
    `Transcript` above is its plain version, which the tests hold it
    against."""
    return NativeTranscript(label)
