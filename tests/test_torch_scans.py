"""The MSM's bucket merge (K3), window sums (K4) and Horner (K5) plain
versions on the CPU, in the order of adds that the CUDA kernels follow
(ops/msm_serial): bucket sums against sums formed with the host group law,
on buckets whose lane counts sit at the edges of the kernel's 32-lane
strides and shuffle tree; each window against sum_j (j+1) * S_j, on
windows whose set buckets sit at the edges of the kernel's four-bucket
lane segments; the same buckets against the JAX package's window sums; and
Horner on the identity.  Canonical affine values, exact.
"""
import random

import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.ops import fp as jfp, msm_serial as jms
from bulletproof_gadgets_tpu_torch.core.gens import BulletproofGens
from bulletproof_gadgets_tpu_torch.core.ristretto import P, RistrettoPoint
from bulletproof_gadgets_tpu_torch.ops import curve, fp, msm_serial as ms

torch.set_num_threads(1)

N = 64                                    # table points (rows 0..2N)
SEG = ms.BUCKETS_PER_LANE
# window -> its set buckets
WINDOWS = {
    "empty": [],
    "bucket 0": [0],
    "bucket 127": [ms.NB - 1],
    "segment starts": list(range(0, ms.NB, SEG)),
    "segment ends": list(range(SEG - 1, ms.NB, SEG)),
    "all 128": list(range(ms.NB)),
}


def _affine(pt):
    zi = pow(pt.Z, P - 2, P)
    return (pt.X * zi % P, pt.Y * zi % P)


@pytest.fixture(scope="module")
def windows():
    """Bucket sums S [4, NL, len(WINDOWS) * NB] (a set bucket holds one
    table point or its negation, an empty one the identity, as K3 leaves
    them) and the host's sum_j (j+1) * S_j of each window."""
    pts = list(BulletproofGens(N, device="cpu").G(N))
    table = pts + [-p for p in pts] + [RistrettoPoint.identity()]
    r = random.Random(11)
    idx = [2 * N] * (len(WINDOWS) * ms.NB)
    want = []
    for w, live in enumerate(WINDOWS.values()):
        acc = RistrettoPoint.identity()
        for j in live:
            row = r.randrange(2 * N)
            idx[w * ms.NB + j] = row
            acc = acc + table[row].scalar_mul(j + 1)
        want.append(_affine(acc))
    src = torch.from_numpy(ms.prep_source(pts))
    buckets = ms.bucket_accumulate(
        src, torch.tensor([idx], dtype=torch.int32))
    return buckets, want


def test_window_sums_plain_match_host(windows):
    buckets, want = windows
    got = curve.canonical_affine(curve.unstack(ms.window_sums(buckets)))
    assert dict(zip(WINDOWS, got)) == dict(zip(WINDOWS, want))


def test_window_sums_plain_match_jax_package(windows, monkeypatch):
    """The JAX package's window sums (_window_scan_fused through its
    per-step branch: the same double masked suffix scan as
    _window_scan_kernel, which in interpret mode compiles for ~30 s) on
    the same buckets of two windows."""
    buckets, _ = windows
    two = buckets.view(4, ms.NL, -1, ms.NB)[:, :, -2:].reshape(4, ms.NL, -1)
    nb, log_steps = jms._WIN[ms.C][1], jms._WIN[ms.C][3]
    rev = tuple(
        np.ascontiguousarray(fp.limbs_to_limbs13(two[c].numpy())
                             .reshape(jfp.NL, 2, nb)[:, :, ::-1]
                             .reshape(jfp.NL, -1)) for c in range(4))
    monkeypatch.setenv("BPG_TPU_MSM_FUSED_SCAN", "0")
    total = jms._window_scan_fused(rev, nb, log_steps)
    x, y, z = (jfp.from_limbs(np.asarray(c)[:, nb - 1::nb].T)
               for c in total[:3])
    want = [(xi * pow(zi, P - 2, P) % P, yi * pow(zi, P - 2, P) % P)
            for xi, yi, zi in zip(x, y, z)]
    got = curve.canonical_affine(curve.unstack(ms.window_sums(
        two.contiguous())))
    assert got == want


@pytest.mark.parametrize("k", [1, 3])
def test_horner_plain_on_identity(k):
    ws = curve.stack(curve.identity((k * ms.W,), torch.device("cpu")))
    got = curve.canonical_affine(curve.unstack(ms.horner(ws, k)))
    assert got == [(0, 1)] * k


# K3: lanes per bucket, at the edges of the kernel's strides and tree
SUBS = [0, 1, 2, 31, 32, 33, 64, 137]
# pool lanes per bucket that make merge_shape give G = 1, 4, 32 (so 31-137
# are long at G = 1, 137 at G = 4, none at G = 32)
AVG = {1: 4, 4: 40, 32: 300}


def split_buckets(subs, g, r):
    """(offs, sub, p): buckets of `subs` lanes laid out in a pool of p lanes
    out of order and with gaps between them (non-contiguous offs), among
    empty buckets and unused lanes so that merge_shape(p, len(sub)) gives
    G = g."""
    order = list(range(len(subs)))
    r.shuffle(order)
    offs, lo = [0] * len(subs), 0
    for b in order:
        lo += r.randrange(1, 4)                 # a gap of unused lanes
        offs[b] = lo
        lo += subs[b]
    p = max(lo, AVG[g] * len(subs))
    offs, subs = list(offs), list(subs)
    for _ in range(-(-p // AVG[g]) - len(subs)):   # empty buckets
        at = r.randrange(len(subs) + 1)
        offs.insert(at, r.randrange(p + 1))
        subs.insert(at, 0)
    return offs, subs, p


@pytest.mark.parametrize("g", sorted(AVG))
def test_bucket_merge_plain_matches_host(g):
    """Buckets of SUBS lanes each (split_buckets), each lane a random table
    point or its negation: every bucket equals the host sum of its lanes,
    with K3's group width G = g."""
    pts = list(BulletproofGens(N, device="cpu").G(N))
    table = pts + [-p for p in pts]
    r = random.Random(12 + g)
    offs, subs, p = split_buckets(SUBS, g, r)
    assert ms.merge_shape(p, len(subs))[0] == g
    rows = [r.randrange(2 * N) for _ in range(p)]
    src = torch.from_numpy(ms.prep_source(pts))
    pool = ms.bucket_accumulate(src, torch.tensor([rows], dtype=torch.int32))
    got = curve.canonical_affine(curve.unstack(ms.bucket_merge(
        pool, torch.tensor(offs, dtype=torch.int32),
        torch.tensor(subs, dtype=torch.int32))))
    want = []
    for o, n_sub in zip(offs, subs):
        acc = RistrettoPoint.identity()
        for row in rows[o:o + n_sub]:
            acc = acc + table[row]
        want.append(_affine(acc))
    assert got == want
