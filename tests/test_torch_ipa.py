"""The port's device inner-product argument on the CPU (where every kernel
wrapper runs its plain PyTorch version) against the JAX package: F_l
arithmetic and the device digit recode (ops/fl, ops/flvec), one round's fold
and scalars (ops/ipa_device), the fold slab and the materialized table
(ops/ipa_fold, kernel K6's plain version), and whole arguments
(ops/ipa_fused) against the JAX package's host IPA.

Inputs come from numpy seeds and go to both packages as Python ints or as
the JAX package's limb rows carried over with ops/fl.from_rows13.  The
arithmetic is exact, so every comparison is equality of canonical values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.core import msm as jax_core_msm
from bulletproof_gadgets_tpu.core.gens import PedersenGens as JaxPedersen
from bulletproof_gadgets_tpu.core.ipa import InnerProductProof as JaxIPP
from bulletproof_gadgets_tpu.core.ristretto import RistrettoPoint as JaxPoint
from bulletproof_gadgets_tpu.core.scalar import Scalar as JaxScalar
from bulletproof_gadgets_tpu.ops import fl as jfl, flvec as jflvec
from bulletproof_gadgets_tpu.ops import ipa_device as jipa_device
from bulletproof_gadgets_tpu.ops import ipa_fold as jipa_fold
from bulletproof_gadgets_tpu.ops import msm_serial as jms
from bulletproof_gadgets_tpu.utils.merlin import Transcript as JaxTranscript
from bulletproof_gadgets_tpu_torch.core.gens import (BulletproofGens,
                                                     PedersenGens)
from bulletproof_gadgets_tpu_torch.core.ristretto import P
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.core.transcript import (
    innerproduct_domain_sep)
from bulletproof_gadgets_tpu_torch.ops import (fl, flvec, fp, ipa_device,
                                               ipa_fold, ipa_fused,
                                               msm_serial as ms)
from bulletproof_gadgets_tpu_torch.ops.msm import signed_digits
from bulletproof_gadgets_tpu_torch.utils.merlin import Transcript

torch.set_num_threads(1)

R_INV = pow(fl.R, -1, L)                 # the port's Montgomery R = 2^260
JAX_R_INV = pow(jfl.R, -1, L)            # the JAX package's R = 2^273
EDGES = [0, 1, 2, L - 1, L - 2, (1 << 252), (1 << 252) - 1]
ABOVE_L = [L, L + 1, 2 * L + 5, (1 << 253) - 1, (1 << 254) - 1]


def _rand(seed, n):
    raw = np.random.default_rng(seed).bytes(40 * n)
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little") % L
            for i in range(n)]


def _jax_ints(rows):
    return [v % L for v in jfl.from_limbs(np.asarray(rows))]


def _digit_values(dig):
    """[W, n] signed base-256 digits -> the n scalars mod l."""
    d = np.asarray(dig).astype(object)
    return [sum(int(d[w, j]) << (8 * w) for w in range(d.shape[0])) % L
            for j in range(d.shape[1])]


# -- F_l and digits ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_mont_mul_and_add_match_jax(seed):
    a = _rand(seed, 40) + EDGES + ABOVE_L          # std, some >= l
    y = _rand(seed + 10, len(a))                    # multiplied in mont form
    want = [x * v % L for x, v in zip(a, y)]
    got = fl.mont_mul(fl.to_limbs(a), flvec.to_mont(y))
    assert fl.limbs_to_ints(got) == want
    assert int(got.min()) >= 0 and int(got.max()) <= fl.MASK   # canonical
    assert all(v < L for v in (
        sum(int(r[j]) << (fl.B * j) for j in range(fl.NW))
        for r in got.tolist()))
    jax_got = jax.jit(jfl.mont_mul)(jnp.asarray(jflvec.to_limbs(a)),
                                    jnp.asarray(jflvec.to_mont(y)))
    assert _jax_ints(jax_got) == want
    # add on canonical values; to_mont/from_mont round trip
    b = [x % L for x in a]
    assert fl.limbs_to_ints(fl.add(fl.to_limbs(b), fl.to_limbs(y))) == \
        [(x + v) % L for x, v in zip(b, y)]
    assert fl.limbs_to_ints(fl.from_mont(fl.to_mont(fl.to_limbs(a)))) == \
        [x % L for x in a]
    # the JAX package's rows carried over: std and Montgomery
    assert fl.limbs_to_ints(fl.from_rows13(jflvec.to_limbs(a))) == \
        [x % L for x in a]
    assert fl.limbs_to_ints(fl.from_mont(fl.from_rows13(
        jflvec.to_mont(y), mont=True))) == y


def test_digits_device_matches_signed_digits_and_jax():
    vals = _rand(2, 60) + EDGES + ABOVE_L
    got = flvec.digits_device(fl.to_limbs(vals))
    assert got.dtype == torch.int8 and got.shape == (32, len(vals))
    assert np.array_equal(got.numpy().astype(np.int32).T,
                          signed_digits(vals, 8))
    jax_dig = jflvec.digits_device(jnp.asarray(jflvec.to_limbs(vals)))
    assert np.array_equal(got.numpy(), np.asarray(jax_dig))


def test_sum_rows_and_digits4():
    vals = _rand(3, 3 * 70)
    rows = fl.to_limbs(vals).view(3, 70, fl.NW)
    assert fl.limbs_to_ints(flvec.sum_rows(rows)) == [
        sum(vals[70 * i:70 * i + 70]) % L for i in range(3)]
    std = _rand(4, 30) + EDGES
    e = ipa_fold.digits4_dev(fl.to_limbs(std)).numpy().astype(object)
    assert e.min() >= 0 and e.max() <= 15
    assert [sum((int(e[w, j]) - 8) << (4 * w) for w in range(64))
            for j in range(len(std))] == std
    jax_e = jax.jit(jipa_fold.digits4_dev)(
        jnp.asarray(jflvec.to_limbs(std)))
    assert np.array_equal(e.astype(np.int64), np.asarray(jax_e))


# -- one round: fold and scalars ---------------------------------------------

@pytest.mark.parametrize("rnd", [0, 2])
def test_fold_and_scalars_match_jax(rnd):
    n = 16
    a, b = _rand(5, n), _rand(6, n)
    gc, hc = _rand(7, n), _rand(8, n)              # std values, mont rows
    u = _rand(9, 1)[0]
    w = _rand(10, 1)[0]
    jm = jipa_device.round_masks(n)[rnd]
    pm = ipa_device.round_masks(n, "cpu")[rnd]
    j_out = jipa_device._fold(
        jnp.asarray(jflvec.to_limbs(a)), jnp.asarray(jflvec.to_limbs(b)),
        jnp.asarray(jflvec.to_mont(gc)), jnp.asarray(jflvec.to_mont(hc)),
        jnp.asarray(jflvec.to_mont([u])),
        jnp.asarray(jflvec.to_mont([pow(u, L - 2, L)])), jm["ga"], jm["hi"])
    p_out = ipa_device._fold(
        fl.to_limbs(a), fl.to_limbs(b), flvec.to_mont(gc), flvec.to_mont(hc),
        *flvec.to_mont([u, pow(u, L - 2, L)]).unbind(0), pm["ga"], pm["hi"])
    for k, (jx, px) in enumerate(zip(j_out, p_out)):
        jv, pv = _jax_ints(jx), fl.limbs_to_ints(px)
        if k >= 2:                                 # gc, hc: Montgomery
            jv = [v * JAX_R_INV % L for v in jv]
            pv = [v * R_INV % L for v in pv]
        assert jv == pv, k
    # this round's digits: the same scalar in every column
    j_dig = jipa_device._scalars(
        *j_out, jnp.asarray(jflvec.to_limbs([w * jfl.R * jfl.R % L]))[0],
        jm["ga"], jm["hi"], jm["cs"], jm["lo_i"], jm["hi_i"])
    p_dig = ipa_device._scalars(
        *p_out, fl.to_limbs([w * fl.R * fl.R % L])[0], pm)
    assert p_dig.shape == tuple(j_dig.shape) == (64, 2 * n + 2)
    for half in (slice(0, 32), slice(32, 64)):
        assert _digit_values(p_dig[half].numpy()) == \
            _digit_values(np.asarray(j_dig)[half])


# -- the fold ----------------------------------------------------------------

def _table(n):
    pc = PedersenGens.default()
    bp = BulletproofGens(n, device="cpu")
    return list(bp.G(n)) + list(bp.H(n)) + [pc.B, pc.B_blinding]


def test_fold_slab_matches_jax_interpret():
    """One slab (n_t = 16, d = 2: 4 outputs of 4 terms over the H half)
    against the JAX package's _mat_slab, its Pallas ladder in interpret
    mode."""
    n_t, d, o_n = 16, 2, 4
    pts = _table(n_t)
    src13, _ = jms.prep_source([JaxPoint(p.X, p.Y, p.Z, p.T) for p in pts])
    src = torch.from_numpy(ms.source_from_rows13(np.asarray(src13)))
    assert torch.equal(src, torch.from_numpy(ms.prep_source(pts)))
    coeff = _rand(11, n_t)
    j_rows, j_negs = jipa_fold._mat_slab(
        src13, jnp.asarray(jflvec.to_mont(coeff)), 0, n_t, d, o_n, n_t,
        len(pts))
    rows, negs = ipa_fold._mat_slab(src, (flvec.to_mont(coeff),), 0, n_t, d,
                                    o_n, (n_t,))
    assert np.array_equal(rows.numpy(),
                          ms.source_from_rows13(np.asarray(j_rows)))
    assert np.array_equal(negs.numpy(),
                          ms.source_from_rows13(np.asarray(j_negs)))


def test_materialize_matches_host_group_law():
    """n_t = 64, d = 3: every folded G' and H' row against the sum of the
    JAX package's host scalar multiples; B, B_blinding and the identity
    keep their rows."""
    n_t, d = 64, 3
    n_out, k_terms = n_t >> d, 1 << d
    pts = _table(n_t)
    src = torch.from_numpy(ms.prep_source(pts))
    gc, hc = _rand(12, n_t), _rand(13, n_t)
    new = ipa_fold.materialize(src, flvec.to_mont(gc), flvec.to_mont(hc),
                               n_t, d, len(pts))
    m = 2 * n_out + 2
    assert new.shape == (2 * m + 1, ms.ROW)
    jpts = [JaxPoint(p.X, p.Y, p.Z, p.T) for p in pts]
    want = []
    for off, coeff in ((0, gc), (n_t, hc)):
        for i in range(n_out):
            acc = JaxPoint.identity()
            for k in range(k_terms):
                t = i + k * n_out
                acc = acc + jpts[off + t].scalar_mul(coeff[t])
            zi = pow(acc.Z, P - 2, P)
            want.append((acc.X * zi % P, acc.Y * zi % P))
    old = src.numpy()
    want_b = [tuple(fp.limbs_to_ints(old[r, c * 10:c * 10 + 10, None])[0]
                    for c in range(2)) for r in (2 * n_t, 2 * n_t + 1)]
    got = new.numpy()
    xs, ys, ts = (fp.limbs_to_ints(got[:, c * 10:c * 10 + 10].T)
                  for c in range(3))
    assert list(zip(xs, ys))[:m] == want + want_b
    negs = list(zip(xs, ys))[m:2 * m]
    assert negs == [(-x % P, y) for x, y in want + want_b]
    d2 = 2 * (-121665 * pow(121666, P - 2, P)) % P
    assert ts[:m] == [x * y * d2 % P for x, y in want + want_b]
    assert np.array_equal(got[2 * m], old[-1])             # identity
    widths = np.array(fp.W * 3)                            # canonical limbs
    assert (got[:, :30] >= 0).all() and (got[:, :30] >> widths == 0).all()
    assert (got[:, 30:] == 0).all()


def test_ladder_fold_rejects_too_many_terms():
    """Folds of more than MAX_TERMS terms raise on the CPU too (the kernel's
    limit is part of the specification), and fewer do not."""
    src = torch.from_numpy(ms.prep_source(_table(4)))
    for k, ok in ((ipa_fold.MAX_TERMS + 1, False), (1, True)):
        base = torch.zeros((k, 2), dtype=torch.int32)
        dig = torch.full((64 * k, 2), 8, dtype=torch.int32)
        if ok:
            assert ipa_fold.ladder_fold(src, base, dig).shape == (2, 2,
                                                                  ms.ROW)
        else:
            with pytest.raises(ValueError):
                ipa_fold.ladder_fold(src, base, dig)


# -- whole arguments ---------------------------------------------------------

@pytest.mark.parametrize("n,fold_at,folds", [
    (2, ipa_fold.FOLD_AT, 0), (8, ipa_fold.FOLD_AT, 0),
    (32, ipa_fold.FOLD_AT, 0), (64, 2, 1), (256, 3, 1)])
def test_ipa_matches_jax_host(n, fold_at, folds, monkeypatch):
    """ipa_fused.create (fold_min = 4, so the small tables fold) against
    the JAX package's host IPA with its host MSM: L/R bytes, a, b, and the
    transcript state after the argument."""
    monkeypatch.setattr(jax_core_msm, "_backend", None)
    a, b = _rand(20 + n, n), _rand(30 + n, n)
    y_inv, w = _rand(40 + n, 2)
    h_factors = [pow(y_inv, i, L) for i in range(n)]
    jpc = JaxPedersen.default()
    jpts = [JaxPoint(p.X, p.Y, p.Z, p.T) for p in _table(n)]
    t_host = JaxTranscript(b"ipa-port-test")
    host = JaxIPP.create(
        t_host, jpc.B.scalar_mul(w), [JaxScalar(1)] * n,
        [JaxScalar(v) for v in h_factors], jpts[:n], jpts[n:2 * n],
        [JaxScalar(v) for v in a], [JaxScalar(v) for v in b])

    calls = []
    real = ipa_fold.materialize
    monkeypatch.setattr(ipa_fold, "materialize",
                        lambda *args: calls.append(args[3]) or real(*args))
    pc = PedersenGens.default()
    bp = BulletproofGens(n, device="cpu")
    table = ms.GeneratorTable(list(bp.G(n)), list(bp.H(n)), pc.B,
                              pc.B_blinding, "cpu")
    t_port = Transcript(b"ipa-port-test")
    innerproduct_domain_sep(t_port, n)
    L_vec, R_vec, a0, b0 = ipa_fused.create(
        t_port, table, w, [1] * n, h_factors, a, b, fold_at=fold_at,
        fold_min=4)
    assert len(calls) == folds
    assert L_vec == host.L_vec and R_vec == host.R_vec
    assert (a0, b0) == (host.a.v % L, host.b.v % L)
    assert t_host.challenge_bytes(b"x", 32) == t_port.challenge_bytes(b"x", 32)


def _host_ipa(label, prior, n, w, h_factors, a, b):
    """The JAX package's host IPA on a transcript that first absorbs
    `prior` 32-byte messages -> (proof, transcript after it)."""
    jpc = JaxPedersen.default()
    jpts = [JaxPoint(p.X, p.Y, p.Z, p.T) for p in _table(n)]
    t = JaxTranscript(label)
    for m in prior:
        t.append_message(b"V", m)
    proof = JaxIPP.create(
        t, jpc.B.scalar_mul(w), [JaxScalar(1)] * n,
        [JaxScalar(v) for v in h_factors], jpts[:n], jpts[n:2 * n],
        [JaxScalar(v) for v in a], [JaxScalar(v) for v in b])
    return proof, t


def _port_transcript(label, prior, n):
    t = Transcript(label)
    for m in prior:
        t.append_message(b"V", m)
    innerproduct_domain_sep(t, n)
    return t


def _no_host_points(monkeypatch):
    def refuse(cols):
        raise AssertionError("points_from_cols called by the device IPA")
    monkeypatch.setattr(ms, "points_from_cols", refuse)


@pytest.mark.parametrize("counts", [(1, 1, 1), (0, 3, 1)])
def test_create_batched_matches_jax_host(counts, monkeypatch):
    """create_batched over three proofs of a 16-gens table whose
    transcripts absorbed 1, 1, 1 or 0, 3, 1 commitments first (a group of
    mixed commitment counts, so three byte positions): each proof's L/R
    bytes, a0, b0 and transcript state afterwards equal the JAX package's
    host IPA on the same inputs, and no point is read back."""
    monkeypatch.setattr(jax_core_msm, "_backend", None)
    _no_host_points(monkeypatch)
    n = 16
    rng = np.random.default_rng(sum(counts))
    priors = [[rng.bytes(32) for _ in range(c)] for c in counts]
    args = [(_rand(50 + i, n), _rand(60 + i, n), _rand(70 + i, 2))
            for i in range(3)]
    pc = PedersenGens.default()
    bp = BulletproofGens(n, device="cpu")
    table = ms.GeneratorTable(list(bp.G(n)), list(bp.H(n)), pc.B,
                              pc.B_blinding, "cpu")
    ts = [_port_transcript(b"batch-ipa", p, n) for p in priors]
    hfs = [[pow(yi, j, L) for j in range(n)] for _, _, (yi, _) in args]
    outs = ipa_fused.create_batched(
        ts, table, [w for _, _, (_, w) in args], [[1] * n] * 3, hfs,
        [a for a, _, _ in args], [b for _, b, _ in args])
    for (a, b, (_, w)), hf, p, t, out in zip(args, hfs, priors, ts, outs):
        host, t_host = _host_ipa(b"batch-ipa", p, n, w, hf, a, b)
        assert out[0] == host.L_vec and out[1] == host.R_vec
        assert out[2:] == (host.a.v % L, host.b.v % L)
        assert t.challenge_bytes(b"x", 32) == t_host.challenge_bytes(b"x", 32)


def test_create_reads_back_once_per_round(monkeypatch):
    """A 64-gens argument (6 rounds) with one table fold: no point read
    back (points_from_cols refuses), and the one tensor it reads back is
    the result at the end, with the rounds' pool excesses in it (Tensor.cpu
    counted): the MSM schedule is built on the device from the shape, so
    no round reads its bucket counts back."""
    n = 64
    _no_host_points(monkeypatch)
    folds, real_fold = [], ipa_fold.materialize
    monkeypatch.setattr(ipa_fold, "materialize",
                        lambda *args: folds.append(args[3]) or
                        real_fold(*args))
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **kw: calls.append(self.shape)
                        or real_cpu(self, *a, **kw))
    pc = PedersenGens.default()
    bp = BulletproofGens(n, device="cpu")
    table = ms.GeneratorTable(list(bp.G(n)), list(bp.H(n)), pc.B,
                              pc.B_blinding, "cpu")
    t = _port_transcript(b"readbacks", [], n)
    a, b = _rand(81, n), _rand(82, n)
    calls.clear()
    out = ipa_fused.create(t, table, 5, [1] * n, [1] * n, a, b, fold_at=2,
                           fold_min=4)
    assert len(out[0]) == 6 and folds == [n]
    nw = ipa_fused.fl.NW
    assert calls == [(6 * 64 + 6 + 2 * nw + 200 + 3,)]
