"""The port's C Merlin transcript (capi/merlin_native.c) against its plain
version, the port's pure-Python utils/merlin.Transcript: the same script
gives the same challenges, Merlin's published vector, the device
transcript's snapshot / write-back of the C layout, the entry points'
factory, and a failed build that raises.
"""
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu_torch import capi
from bulletproof_gadgets_tpu_torch.lang import prove as port_prove
from bulletproof_gadgets_tpu_torch.lang import verify as port_verify
from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
from bulletproof_gadgets_tpu_torch.utils import merlin
from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript


def test_native_matches_python():
    """The script of tests/test_native_transcript.py (the JAX package's C
    transcript against its Python one)."""
    tp = Transcript(b"test protocol")
    tn = capi.NativeTranscript(b"test protocol")
    script = [(b"some label", b"some data"), (b"x", b""),
              (b"big", bytes(range(256)) * 3)]
    for label, msg in script:
        tp.append_message(label, msg)
        tn.append_message(label, msg)
        assert tp.challenge_bytes(b"c", 32) == tn.challenge_bytes(b"c", 32)
    tp.append_u64(b"m", 123456789)
    tn.append_u64(b"m", 123456789)
    assert tp.challenge_bytes(b"final", 64) == tn.challenge_bytes(b"final", 64)


def test_native_merlin_vector():
    t = capi.NativeTranscript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def test_snapshot_and_write_back_of_the_c_layout():
    """snapshot_host reads the C transcript's bpg_strobe as the Python
    one's state; an IPA round run on the snapshot (transcript_round's plain
    version) and written back leaves both transcripts with the same next
    challenge, and a bare state written back likewise."""
    tn, tp = capi.NativeTranscript(b"R1CSProof"), Transcript(b"R1CSProof")
    for t in (tn, tp):
        t.append_message(b"V", bytes(range(200)))      # crosses a permutation
        t.append_u64(b"n", 64)
    for a, b in zip(sd.snapshot_host(tn), sd.snapshot_host(tp)):
        assert np.array_equal(a, b)

    state, meta = sd.snapshot([tn, tp], "cpu")
    enc = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, 2, 32), dtype=np.uint8))
    enc[1] = enc[0]
    out_s, out_m, _ = sd.transcript_round_plain(state, meta, enc)
    for i, t in enumerate((tn, tp)):
        sd.write_back(t, out_s[i].numpy(), out_m[i].tolist())
    assert tn.challenge_bytes(b"x", 64) == tp.challenge_bytes(b"x", 64)

    # a state carried on elsewhere (the Python transcript, one message
    # further) written into the C transcript
    tp.append_message(b"more", b"\x01" * 150)
    snap = sd.snapshot_host(tp)
    sd.write_back(tn, snap[0], snap[1:])
    assert tn.strobe_state() == tp.strobe_state()
    assert tn.challenge_bytes(b"y", 32) == tp.challenge_bytes(b"y", 32)
    with pytest.raises(ValueError):
        tn.set_strobe_state(b"\x00" * 199, 0, 0, 0)


def test_entry_points_use_the_c_transcript():
    """lang.prove / lang.verify build their transcripts through
    utils/merlin.new_transcript, which is the C one, never the Python
    one."""
    assert port_prove.Transcript is merlin.new_transcript
    assert port_verify.Transcript is merlin.new_transcript
    assert type(merlin.new_transcript(b"x")) is capi.NativeTranscript


def test_failed_build_raises(monkeypatch, tmp_path):
    """A C compiler that fails: load() raises with its output, and the
    factory raises with it (no Python transcript instead)."""
    monkeypatch.setattr(capi, "_LIB", None)
    monkeypatch.setattr(capi, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(capi, "_target", lambda stem, *a, **kw: str(
        tmp_path / f"{stem}.so"))
    monkeypatch.setattr(capi, "_cc", lambda: "false")
    with pytest.raises(RuntimeError, match="cc failed"):
        capi.load()
    with pytest.raises(RuntimeError, match="cc failed"):
        merlin.new_transcript(b"x")
