"""The MSM's window sums (K4) and Horner (K5) plain versions on the CPU, in
the order of adds that the CUDA kernels follow (ops/msm_serial): each
window against sum_j (j+1) * S_j formed with the host group law, on windows
whose set buckets sit at the edges of the kernel's four-bucket lane
segments; the same buckets against the JAX package's window sums; and
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
    pts = list(BulletproofGens(N).G(N))
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
