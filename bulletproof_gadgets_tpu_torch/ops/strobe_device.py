"""STROBE-128 / Merlin transcript operations on device states: the port of
the JAX package's ops/strobe_device.py, and the IPA round's Fiat-Shamir
step as one kernel (`transcript_round`).

A transcript's duplex state is a uint8 [200] row; a group of B transcripts
is [B, 200] with their byte positions (pos, pos_begin, cur_flags) in an
int32 [B, 3] tensor beside it, on the same device, so a group may mix
statements whose transcripts stand at different positions (proofs of
different commitment counts).  `snapshot` copies host transcripts
(capi.NativeTranscript on the path; utils/merlin.Transcript, its plain
version, in tests) to the device; `write_back` sets a host
transcript's state and positions from a device row that was read back,
where the JAX package's `replay_host` re-ran Keccak on the host.

`transcript_round` (csrc/transcript.cu) does one IPA round for each of the
B transcripts: Merlin's append_message(b"L", L), append_message(b"R", R)
and challenge_bytes(b"u", 64), then u = the 64 bytes mod l and u^-1, as
ops/fl Montgomery rows [B, 2, NW] for the next fold.  Its plain version,
`transcript_round_plain`, runs `DeviceStrobe` (the duplex over a batch of
states that share their positions, with ops/keccak_device.f1600) on each
group of equal positions, and the challenge's F_l steps of
ops/ristretto_device (u^(l-2) where the kernel runs divsteps: the same
canonical rows by another algorithm).  Each launch counts in native.LAUNCHES
["transcript_round"] (those of `challenge_rows`, its check-only mode, in
["challenge_rows"]); CPU tensors take the plain version.

Oracle: utils/merlin.py (tests/test_torch_device_transcript.py).
"""
import numpy as np
import torch

from . import keccak_device, ristretto_device
from .fl import NW
from .. import native
from ..utils.merlin import (STROBE_R, _FLAG_A, _FLAG_C, _FLAG_I, _FLAG_K,
                            _FLAG_M)


class DeviceStrobe:
    """STROBE-128 duplex over uint8 [B, 200] states that share their byte
    positions (Python ints), utils/merlin.Strobe128's steps on tensors."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, state, pos: int, pos_begin: int, cur_flags: int):
        self.state = state.clone()
        self.pos = pos
        self.pos_begin = pos_begin
        self.cur_flags = cur_flags

    @property
    def meta(self):
        return (self.pos, self.pos_begin, self.cur_flags)

    def _run_f(self):
        s = self.state
        s[:, self.pos] ^= self.pos_begin
        s[:, self.pos + 1] ^= 0x04
        s[:, STROBE_R + 1] ^= 0x80
        self.state = keccak_device.f1600_state(s)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data):
        """data: uint8 [B, k] (one message per state) or host bytes."""
        if isinstance(data, (bytes, bytearray)):
            data = torch.tensor(list(data), dtype=torch.uint8,
                                device=self.state.device).expand(
                                    self.state.shape[0], -1)
        k, off = data.shape[1], 0
        while off < k:
            run = min(STROBE_R - self.pos, k - off)
            self.state[:, self.pos:self.pos + run] ^= data[:, off:off + run]
            self.pos += run
            off += run
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int):
        outs = []
        while n > 0:
            run = min(STROBE_R - self.pos, n)
            outs.append(self.state[:, self.pos:self.pos + run].clone())
            self.state[:, self.pos:self.pos + run] = 0
            self.pos += run
            n -= run
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(outs, 1)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool):
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    # -- merlin framing ----------------------------------------------------
    def append_message(self, label: bytes, message):
        k = (len(message) if isinstance(message, (bytes, bytearray))
             else message.shape[1])
        self.meta_ad(label, False)
        self.meta_ad(k.to_bytes(4, "little"), True)
        self.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int):
        self.meta_ad(label, False)
        self.meta_ad(n.to_bytes(4, "little"), True)
        return self.prf(n, False)


def snapshot_host(transcript):
    """Host transcript (capi.NativeTranscript, the path's, or
    utils/merlin.Transcript) -> (state np.uint8 [200], pos, pos_begin,
    cur_flags)."""
    state, pos, pos_begin, cur_flags = transcript.strobe_state()
    return (np.frombuffer(state, dtype=np.uint8).copy(), pos, pos_begin,
            cur_flags)


def snapshot(transcripts, device):
    """Host transcripts -> (uint8 [B, 200], int32 [B, 3]) on `device`."""
    snaps = [snapshot_host(t) for t in transcripts]
    state = torch.from_numpy(np.stack([s[0] for s in snaps]))
    meta = torch.tensor([s[1:] for s in snaps], dtype=torch.int32)
    return state.to(device), meta.to(device)


def write_back(transcript, state, meta):
    """Set a host transcript's STROBE state and positions from a device
    row read back: state 200 byte values, meta (pos, pos_begin,
    cur_flags)."""
    transcript.set_strobe_state(bytes(np.asarray(state, dtype=np.uint8)),
                                *(int(v) for v in meta))


def _check_round(states, meta, enc):
    b = states.shape[0]
    for t, name, dtype, shape in ((states, "states", torch.uint8, (b, 200)),
                                  (meta, "meta", torch.int32, (b, 3)),
                                  (enc, "enc", torch.uint8, (b, 2, 32))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 8:
            raise ValueError(f"{name}: not 8-byte aligned")


def transcript_round(states, meta, enc):
    """One IPA round's Fiat-Shamir step for B transcripts: states uint8
    [B, 200], meta int32 [B, 3] (pos, pos_begin, cur_flags), enc uint8
    [B, 2, 32] (each transcript's L and R encodings) -> (states, meta, u)
    after append_message(b"L"), append_message(b"R") and
    challenge_bytes(b"u", 64), with u int64 [B, 2, NW]: the ops/fl
    Montgomery rows of the challenge and of its inverse.

    Replaces the JAX package's jnp round step under jit
    (bulletproof_gadgets_tpu/ops/ipa_fused.py:122 `_round_fs`), which has
    no Pallas kernel.  Bound on the H100: latency, one thread's chain per
    transcript (its bytes through the duplex, one or two Keccak-f[1600],
    the challenge's inversion).  Design (csrc/transcript.cu): one thread
    and block per transcript, its state in a shared-memory work area and
    each permutation's 25 lanes in registers (no local memory), the challenge
    reduced in Montgomery form over 8 x 32-bit words and inverted by
    Bernstein-Yang divsteps (csrc/field_l.cuh; variable time: u is public),
    so one launch per round and nothing read back.  On CUDA the byte
    tensors must be 8-byte aligned (the kernel moves them as 64-bit
    words)."""
    _check_round(states, meta, enc)
    lib = native.kernels_for(states, meta, enc)
    if lib is None:
        return transcript_round_plain(states, meta, enc)
    _check_aligned(states=states, enc=enc)
    b = states.shape[0]
    out_s, out_m = torch.empty_like(states), torch.empty_like(meta)
    u = torch.empty((b, 2, NW), dtype=torch.int64, device=states.device)
    if b:
        native.launched("transcript_round", lib.bpg_transcript_round(
            states.data_ptr(), meta.data_ptr(), enc.data_ptr(), None, b,
            out_s.data_ptr(), out_m.data_ptr(), u.data_ptr(),
            native.stream(states)))
    return out_s, out_m, u


def transcript_round_plain(states, meta, enc):
    out_s, out_m = states.clone(), meta.clone()
    ch = torch.empty((states.shape[0], 64), dtype=torch.uint8,
                     device=states.device)
    groups = {}
    for i, m in enumerate(meta.tolist()):
        groups.setdefault(tuple(m), []).append(i)
    for m, rows in groups.items():
        rows = torch.tensor(rows, device=states.device)
        ds = DeviceStrobe(states[rows], *m)
        ds.append_message(b"L", enc[rows, 0])
        ds.append_message(b"R", enc[rows, 1])
        ch[rows] = ds.challenge_bytes(b"u", 64)
        out_s[rows] = ds.state
        out_m[rows] = torch.tensor(ds.meta, dtype=torch.int32,
                                   device=meta.device)
    return out_s, out_m, challenge_rows_plain(ch)


def challenge_rows(ch):
    """The F_l half of transcript_round on given challenge bytes: uint8
    [B, 64] -> int64 [B, 2, NW] (the same kernel, its STROBE part skipped;
    to hold the kernel's reduction and inversion against the plain version
    on chosen bytes).  The plain version, `challenge_rows_plain`, inverts
    by u^(l-2) where the kernel runs divsteps: both give the canonical
    rows."""
    if ch.dtype != torch.uint8 or ch.dim() != 2 or ch.shape[1] != 64 \
            or not ch.is_contiguous():
        raise ValueError(f"ch: {ch.dtype} {tuple(ch.shape)}, expected "
                         "contiguous uint8 [B, 64]")
    lib = native.kernels_for(ch)
    if lib is None:
        return challenge_rows_plain(ch)
    _check_aligned(ch=ch)
    b = ch.shape[0]
    u = torch.empty((b, 2, NW), dtype=torch.int64, device=ch.device)
    if b:
        native.launched("challenge_rows", lib.bpg_transcript_round(
            None, None, None, ch.data_ptr(), b, None, None, u.data_ptr(),
            native.stream(ch)))
    return u


def challenge_rows_plain(ch):
    u = ristretto_device.challenge_limbs(ch)
    return torch.stack([ristretto_device.to_mont_dev(u),
                        ristretto_device.inv_mont(u)], 1)
