"""The port's device transcript on the CPU (ops/keccak_device,
ops/strobe_device: the plain versions of the transcript kernel) against the
host Merlin transcript (utils/merlin, utils/keccak) and the JAX package's
keccak_device / strobe_device, on seeded numpy inputs.

Byte identity throughout: states, positions and challenge bytes exactly;
the challenge's Montgomery rows exactly (canonical limbs) against
flvec.to_mont of the host's value and inverse.  Mirrors the JAX package's
tests/test_device_transcript.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.ops import keccak_device as jkd
from bulletproof_gadgets_tpu.ops import strobe_device as jsd
from bulletproof_gadgets_tpu.utils.merlin import Transcript as JaxTranscript
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import flvec, keccak_device as kd
from bulletproof_gadgets_tpu_torch.ops import strobe_device as sd
from bulletproof_gadgets_tpu_torch.utils.keccak import f1600_bytes
from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript

torch.set_num_threads(1)


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _u8(rows):
    return torch.tensor([list(r) for r in rows], dtype=torch.uint8)


def _want_rows(ch: bytes):
    """flvec.to_mont of the host's challenge and its inverse."""
    u = int.from_bytes(ch, "little") % L
    return flvec.to_mont([u, pow(u, L - 2, L)])


def test_f1600_matches_host_and_jax():
    """Three seeded states: the plain permutation equals utils/keccak's and
    the JAX package's f1600 (lane halves)."""
    rng = np.random.default_rng(1600)
    states = [_bytes(rng, 200) for _ in range(3)]
    got = kd.f1600_state(_u8(states))
    want = []
    for s in states:
        b = bytearray(s)
        f1600_bytes(b)
        want.append(list(b))
    assert got.tolist() == want
    lo, hi = kd.state_to_lanes(_u8(states))
    j_lo, j_hi = jax.jit(jkd.f1600)(jnp.asarray(lo[0].numpy(), jnp.uint32),
                                    jnp.asarray(hi[0].numpy(), jnp.uint32))
    p_lo, p_hi = kd.f1600(lo, hi)
    assert np.array_equal(np.asarray(j_lo).astype(np.int64), p_lo[0].numpy())
    assert np.array_equal(np.asarray(j_hi).astype(np.int64), p_hi[0].numpy())
    assert kd.lanes_to_state(lo, hi).tolist() == [list(s) for s in states]


def test_device_strobe_matches_host():
    """A mid-protocol host transcript snapshotted: messages that cross the
    166-byte rate boundary, then a challenge, on a batch of two copies of
    the state (the JAX package's test_device_transcript_matches_host)."""
    t = Transcript(b"test-proto")
    t.append_message(b"init", b"some absorbed bytes")
    t.append_u64(b"m", 7)
    t.challenge_bytes(b"warmup", 32)
    state, pos, pb, cf = sd.snapshot_host(t)
    ds = sd.DeviceStrobe(torch.from_numpy(np.stack([state, state])), pos, pb,
                         cf)
    rng = np.random.default_rng(7)
    msgs = [(b"L", bytes(range(32))), (b"R", bytes(range(100, 132))),
            (b"big", _bytes(rng, 200))]
    for label, m in msgs:
        ds.append_message(label, _u8([m, m]))
        t.append_message(label, m)
    got = ds.challenge_bytes(b"u", 64)
    want = t.challenge_bytes(b"u", 64)
    assert got.tolist() == [list(want)] * 2
    assert ds.meta == (t.strobe.pos, t.strobe.pos_begin, t.strobe.cur_flags)
    assert ds.state.tolist() == [list(t.strobe.state)] * 2


def test_device_strobe_matches_jax_device_strobe():
    """One IPA round's absorbs and challenge on the port's DeviceStrobe and
    the JAX package's (under jit), from the same snapshot: equal bytes,
    states and positions."""
    t = JaxTranscript(b"ipa")
    t.append_u64(b"n", 16)
    state, pos, pb, cf = jsd.snapshot_host(t)
    rng = np.random.default_rng(11)
    lb, rb = _bytes(rng, 32), _bytes(rng, 32)

    def run(state, l_d, r_d):
        ds = jsd.DeviceStrobe(state, pos, pb, cf)
        ds.append_message(b"L", l_d)
        ds.append_message(b"R", r_d)
        return ds.challenge_bytes(b"u", 64), ds.state

    as_j = [jnp.asarray(np.frombuffer(b, np.uint8).astype(np.int32))
            for b in (lb, rb)]
    j_out, j_state = jax.jit(run)(jnp.asarray(state), *as_j)
    ds = sd.DeviceStrobe(torch.from_numpy(state.astype(np.uint8))[None],
                         pos, pb, cf)
    ds.append_message(b"L", _u8([lb]))
    ds.append_message(b"R", _u8([rb]))
    out = ds.challenge_bytes(b"u", 64)
    assert out[0].tolist() == np.asarray(j_out).tolist()
    assert ds.state[0].tolist() == np.asarray(j_state).tolist()


def _transcripts(seed, counts):
    """Host transcripts at different byte positions: transcript i absorbs
    counts[i] 32-byte messages (as proofs of as many commitments do)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in counts:
        t = Transcript(b"R1CSProof")
        for _ in range(c):
            t.append_message(b"V", _bytes(rng, 32))
        t.append_u64(b"n", 64)
        out.append(t)
    return out


def test_transcript_round_plain_matches_host_rounds():
    """Three transcripts at three different positions (0, 3 and 5
    commitments), four chained rounds of seeded L/R encodings through
    transcript_round (its plain version on CPU tensors): each state,
    position and challenge row equals the host loop's, and write_back
    leaves the host transcripts where the host loop leaves them."""
    counts = (0, 3, 5)
    dev_ts, host_ts = _transcripts(3, counts), _transcripts(3, counts)
    state, meta = sd.snapshot(dev_ts, "cpu")
    assert len({tuple(m) for m in meta.tolist()}) == 3
    rng = np.random.default_rng(4)
    for _ in range(4):
        encs = [(_bytes(rng, 32), _bytes(rng, 32)) for _ in counts]
        enc = _u8([l + r for l, r in encs]).view(3, 2, 32)
        state, meta, u = sd.transcript_round(state, meta, enc)
        assert u.dtype == torch.int64 and u.shape == (3, 2, flvec.NW)
        for i, (t, (lb, rb)) in enumerate(zip(host_ts, encs)):
            t.append_message(b"L", lb)
            t.append_message(b"R", rb)
            ch = t.challenge_bytes(b"u", 64)
            assert torch.equal(u[i], _want_rows(ch))
            assert state[i].tolist() == list(t.strobe.state)
            assert meta[i].tolist() == [t.strobe.pos, t.strobe.pos_begin,
                                        t.strobe.cur_flags]
    for t, st, m in zip(dev_ts, state.numpy(), meta.numpy()):
        sd.write_back(t, st, m)
    for a, b in zip(dev_ts, host_ts):
        assert a.challenge_bytes(b"x", 32) == b.challenge_bytes(b"x", 32)


@pytest.mark.parametrize("which", ["edges", "random"])
def test_challenge_rows_plain(which):
    """The F_l half of the round on chosen bytes: values below l, l itself,
    values >= l, near 2^512, all zeros and all ones (edges), and 64 seeded
    strings (random): the Montgomery rows of the value mod l and of its
    inverse, canonical limbs."""
    if which == "edges":
        vals = [0, 1, L - 1, L, L + 1, 2 * L + 5, (1 << 256) - 1, 1 << 256,
                L << 256, (1 << 512) - 1, (1 << 512) - L, L * L]
        chs = [v.to_bytes(64, "little") for v in vals]
    else:
        rng = np.random.default_rng(64)
        chs = [_bytes(rng, 64) for _ in range(64)]
    u = sd.challenge_rows(_u8(chs))
    for i, ch in enumerate(chs):
        assert torch.equal(u[i], _want_rows(ch))


def test_round_wrappers_check_their_tensors():
    state, meta = sd.snapshot(_transcripts(0, (1,)), "cpu")
    enc = torch.zeros((1, 2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sd.transcript_round(state, meta.to(torch.int64), enc)
    with pytest.raises(ValueError):
        sd.transcript_round(state, meta, enc[:, :1])
    with pytest.raises(ValueError):
        sd.challenge_rows(torch.zeros((2, 32), dtype=torch.uint8))
    assert sd.challenge_rows(torch.zeros((0, 64), dtype=torch.uint8)).shape \
        == (0, 2, flvec.NW)
