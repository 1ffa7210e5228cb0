"""The MSM's shape-static device schedule (ops/msm_serial.schedule) and the
bucket accumulation's stop at a lane's first entry of the identity row, on
the CPU
(every kernel wrapper runs its plain version), and the device generator
map (ops/ristretto_device.points_from_uniform_bytes) against the host's.

Digit matrices are the signed digits of seeded scalar vectors over the
1,024 points of a 512-gens table [G | H]: random scalars, bit vectors,
all ones, all zero, one scalar repeated (every window's entries in one
bucket) and the IPA's L/R halves under their structural bound.  For each:
the lanes the buckets fill stay within the bound P, each lane's entries
are a prefix of its rounds, and the points equal the JAX package's host
Pippenger `core.msm.msm_host`.  A bound too small raises and returns no
point.
"""
import hashlib
import random

import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.core.msm import msm_host
from bulletproof_gadgets_tpu.core.ristretto import RistrettoPoint as JaxPoint
from bulletproof_gadgets_tpu_torch.core.gens import (BulletproofGens,
                                                     _GeneratorsChain)
from bulletproof_gadgets_tpu_torch.core.ristretto import RistrettoPoint
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.ops import (curve, fp, ipa_fused,
                                               msm_serial as ms)

torch.set_num_threads(1)

N = 1 << 10


@pytest.fixture(scope="module")
def table():
    """The 1,024 points [G | H] of a 512-gens table and their rows."""
    gens = BulletproofGens(N // 2, device="cpu")
    pts = list(gens.G(N // 2)) + list(gens.H(N // 2))
    return pts, torch.from_numpy(ms.prep_source(pts))


def _vector(kind, seed):
    r = random.Random(seed)
    if kind == "random":
        return [r.randrange(L) for _ in range(N)]
    if kind == "bits":
        return [r.randrange(2) for _ in range(N)]
    if kind == "ones":
        return [1] * N
    if kind == "zero":
        return [0] * N
    assert kind == "repeated"                  # one bucket per window
    return [r.randrange(L)] * N


def _digits_t(vecs):
    digits = np.concatenate([ms.signed_digits([v % L for v in vec], ms.C)
                             for vec in vecs], 1)
    return torch.from_numpy(np.ascontiguousarray(digits.T, dtype=np.int8))


def _check_schedule(d, n, live_max=None):
    """The schedule's lanes within P, each lane's entries a prefix of its
    rounds, the lanes past the buckets' own all identity."""
    s = ms.schedule(d, n, 0, live_max)
    live = int((d != 0).sum())
    assert live <= (d.numel() if live_max is None else live_max)
    t, p = ms.pool_bound(d.shape[0], d.numel() if live_max is None else
                         min(live_max, d.numel()))
    assert (s.t, s.pool) == (t, p)
    assert int(s.used) <= s.pool
    assert int(s.sub.sum()) == int(s.used)
    idx = ms.idx_rows(s, 0, s.t)
    ident = idx == 2 * n
    assert not bool((ident[:-1] & ~ident[1:]).any())     # a prefix per lane
    assert bool(ident[:, int(s.used):].all())
    assert int((~ident).sum()) == live
    return s


def _host(vecs, pts):
    jpts = [JaxPoint(p.X, p.Y, p.Z, p.T) for p in pts]
    return [msm_host(v, jpts).compress() for v in vecs]


@pytest.mark.parametrize("kinds", [
    ("random",), ("bits",), ("ones",), ("zero",), ("repeated",),
    ("random", "bits", "zero"), ("ones", "repeated", "zero")])
def test_schedule_bound_and_points(table, kinds):
    pts, src = table
    vecs = [_vector(kind, 7 * i + len(kinds)) for i, kind in enumerate(kinds)]
    d = _digits_t(vecs)
    _check_schedule(d, N)
    cols, excess = ms.msm_digits_t(d, src, N)
    assert int(excess) <= 0
    assert [p.compress() for p in ms.points_from_cols(cols, excess)] == \
        _host(vecs, pts)


@pytest.mark.parametrize("proofs, gens", [(1, N // 2), (2, N // 4)])
def test_lr_halves_under_the_structural_bound(table, proofs, gens):
    """One IPA round's L and R over a [G | H | B | B_blinding] table of
    2*gens + 2 points (each G and H point live in one of a proof's L and
    R, B in both, B_blinding in neither), per proof, under
    ipa_fused._lr_live: half the slots' bound, and the points of the host
    MSM."""
    pts, _ = table
    m = 2 * gens + 2
    tab = (pts[:gens] + pts[N // 2:N // 2 + gens]
           + [pts[0] + pts[1], pts[2] + pts[3]])          # B, B_blinding
    src = torch.from_numpy(ms.prep_source(tab))
    r = random.Random(11 + proofs)
    hi = [i >= gens // 2 for i in range(gens)]
    vecs = []
    for _ in range(proofs):
        g_l = [r.randrange(1, L) if h else 0 for h in hi]
        h_l = [0 if h else r.randrange(1, L) for h in hi]
        g_r = [0 if h else r.randrange(1, L) for h in hi]
        h_r = [r.randrange(1, L) if h else 0 for h in hi]
        vecs += [g_l + h_l + [r.randrange(L), 0],
                 g_r + h_r + [r.randrange(L), 0]]
    d = _digits_t(vecs)
    live = ipa_fused._lr_live(m, 2 * proofs)
    s = _check_schedule(d, m, ms.W * int(live.sum()))
    assert s.pool < ms.pool_bound(d.shape[0], d.numel())[1]
    cols, excess = ms.msm_digits_t(d, src, m, live_cols=live,
                                   point_chunk=m // 3)
    assert int(excess) <= 0
    assert [p.compress() for p in ms.points_from_cols(cols)] == \
        _host(vecs, tab)


def test_early_stop_keeps_the_points(table):
    """_madd_rounds (the plain K1) stops a lane at its first entry of the
    identity row: the same points as adding every round (the identity
    rows change the coordinates, not the point), and the same coordinates
    on lanes with no identity entry."""
    pts, _ = table
    n = N // 4
    src = torch.from_numpy(ms.prep_source(pts[:n]))
    d = _digits_t([_vector("bits", 3), _vector("random", 4)])[:, :n]
    idx = ms.plan(d.contiguous(), n)[0]
    got = ms.bucket_accumulate_plain(src, idx)
    acc = curve.identity((idx.shape[1],), "cpu")
    rows = src.to(torch.int64)
    for r in range(idx.shape[0]):
        g = rows[idx[r].long()].t()
        acc = curve.madd(acc, (g[0:fp.NL], g[fp.NL:2 * fp.NL],
                               g[2 * fp.NL:3 * fp.NL]))
    full = curve.stack(tuple(fp.canonical(c) for c in acc))
    assert curve.canonical_affine(curve.unstack(got)) == \
        curve.canonical_affine(curve.unstack(full))
    whole = ~(idx == 2 * n).any(0)
    assert 0 < int(whole.sum()) < idx.shape[1]
    assert torch.equal(got[:, :, whole], full[:, :, whole])
    assert not torch.equal(got, full)


@pytest.mark.parametrize("layout", ["rows", "cols", "flat"])
def test_identity_points_in_the_source(table, layout):
    """A source that holds the identity point itself (as the verifier's
    dynamic MSM does: A_I2, A_O2 and S2 of a one-phase proof), at several
    rows: the identity row of the schedule ends a lane, a source point
    that is the identity does not, so the MSM equals the host's."""
    pts, _ = table
    ident = pts[0] - pts[0]
    src_pts = pts[:200]
    for i in (0, 7, 8, 100, 199):
        src_pts[i] = ident
    src = torch.from_numpy(ms.prep_source(src_pts))
    r = random.Random(13)
    vecs = [[r.randrange(L) for _ in range(200)], [1] * 200]
    cols, excess = ms.msm_digits_t(_digits_t(vecs), src, 200, layout=layout)
    assert [p.compress() for p in ms.points_from_cols(cols, excess)] == \
        _host(vecs, src_pts)


def test_a_bound_too_small_raises(table):
    """A live-entry bound below the digits' own: the schedule raises on
    the CPU, and a device result whose excess is positive raises where it
    is read (points_from_cols, GeneratorTable's finish; the IPA's final
    readback reads it the same way), so no wrong point comes back."""
    pts, _ = table
    n = N // 4
    src = torch.from_numpy(ms.prep_source(pts[:n]))
    d = _digits_t([_vector("random", 5), _vector("bits", 6)])[:, :n]
    d = d.contiguous()
    live = int((d != 0).sum())
    with pytest.raises(RuntimeError, match="pool bound"):
        ms.schedule(d, n, 0, live_max=live // 8)
    with pytest.raises(RuntimeError, match="pool bound"):
        ms.msm_digits_t(d, src, n, live_cols=np.zeros(n, dtype=np.int64))
    cols, _ = ms.msm_digits_t(d, src, n)
    over = torch.tensor(3, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="3 lanes past"):
        ms.points_from_cols(cols, over)
    enc = ms.msm_digits_enc(d, src, n)[0]
    with pytest.raises(RuntimeError, match="pool bound"):
        ms.GeneratorTable.msm_digits_enc_finish((enc, over))


def test_device_map_equals_host_generators():
    """The first 1,024 points of the G chain mapped with batched field ops
    (on the CPU here, in batches of 300) equal RistrettoPoint.
    from_uniform_bytes one by one, coordinate for coordinate."""
    label = b"G" + (0).to_bytes(4, "little")
    from bulletproof_gadgets_tpu_torch.ops.ristretto_device import (
        points_from_uniform_bytes)
    stream = hashlib.shake_256(b"GeneratorsChain" + label).digest(64 * 1024)
    host = [RistrettoPoint.from_uniform_bytes(stream[64 * i:64 * (i + 1)])
            for i in range(1024)]
    dev = points_from_uniform_bytes(stream, "cpu", chunk=300)
    assert [(p.X, p.Y, p.Z, p.T) for p in dev] == \
        [(p.X, p.Y, p.Z, p.T) for p in host]
    chain = _GeneratorsChain(label)
    assert [(p.X, p.Y) for p in chain.take(5, "cpu") + chain.take(7, "cpu")] \
        == [(p.X, p.Y) for p in host[:12]]
