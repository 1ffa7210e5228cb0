"""The port's device vectors on the CPU against the JAX package: the F_l
vector helpers (ops/flvec), the flattening (ops/flatten, forced onto its
device path), the prover's t-poly and l/r vectors (ops/prover_device) and
the verifier's table digits (ops/verifier_device).

Inputs come from numpy seeds; statements are the pinned `bound16` and
`less_than` and one inline MiMC `HASH`, assembled by each package (no
proof is made).  The JAX side runs its host code (the `_flattened_constraints`
loops, the host t-poly formulas) or, for flvec and the table digits, its
jitted device functions on the CPU at small sizes.  The arithmetic is
exact, so every comparison is equality of canonical values.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulletproof_gadgets_tpu.core import r1cs as jax_r1cs
from bulletproof_gadgets_tpu.core.scalar import (Scalar as JaxScalar,
                                                 exp_iter as jax_exp_iter)
from bulletproof_gadgets_tpu.lang.prove import (
    prove_prepared as jax_prove_prepared)
from bulletproof_gadgets_tpu.ops import flvec as jflvec
from bulletproof_gadgets_tpu.ops import verifier_device as jverifier_device
from bulletproof_gadgets_tpu.utils import rng as jax_rng
from bulletproof_gadgets_tpu_torch.core.scalar import L
from bulletproof_gadgets_tpu_torch.lang.prove import prove_prepared
from bulletproof_gadgets_tpu_torch.models.mimc import mimc_hash
from bulletproof_gadgets_tpu_torch.ops import (fl, flatten, flvec,
                                               prover_device, verifier_device)
from bulletproof_gadgets_tpu_torch.utils import rng
from bulletproof_gadgets_tpu_torch.utils.conversions import scalar_to_be

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tests" / "port_pins.json").read_text())


def _rand(seed, n):
    raw = np.random.default_rng(seed).bytes(40 * n)
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little") % L
            for i in range(n)]


def _jax_ints(rows):
    return [v % L for v in jflvec.limbs_to_ints(np.asarray(rows))]


def _digit_values(dig):
    """[W, n] signed base-256 digits -> the n scalars mod l."""
    d = np.asarray(dig).astype(object)
    return [sum(int(d[w, j]) << (8 * w) for w in range(d.shape[0])) % L
            for j in range(d.shape[1])]


def _hash_statement():
    w1 = bytes.fromhex("0539")
    image = scalar_to_be(mimc_hash(w1))
    return ("HASH W0 W1\n", "",
            f"W0 = 0x{image.hex()}\nW1 = 0x{w1.hex()}\n")


def _statement(name):
    if name == "hash":
        return _hash_statement()
    st = PINS["statements"][name]
    return st["gadgets"], st["instance"], st["witness"]


def _prepared(prepare, seed_mod, name):
    gadgets, instance, witness = _statement(name)
    seed_mod.set_seed(PINS["seed"])
    try:
        prover, _, _ = prepare(name, instance, witness, gadgets, [])
    finally:
        seed_mod.set_seed(None)
    return prover


# -- F_l vectors --------------------------------------------------------------

def test_flvec_matches_jax():
    """powers_mont, inner, sub/neg and digits_t_stacked against the JAX
    package's flvec."""
    base = _rand(1, 1)[0]
    for count in (1, 2, 13):
        got = fl.limbs_to_ints(fl.from_mont(flvec.powers_mont(base, count)))
        want = [pow(base, i, L) for i in range(count)]
        assert got == want
    jax_pow = jflvec.powers_mont(base, 4)
    assert [v * pow(1 << 273, -1, L) % L for v in _jax_ints(jax_pow)] == \
        [pow(base, i, L) for i in range(4)]
    a, b = _rand(2, 9), _rand(3, 9)
    assert fl.limbs_to_ints(flvec.inner(fl.to_limbs(a), fl.to_limbs(b))) == \
        _jax_ints(jax.jit(jflvec.inner)(jnp.asarray(jflvec.to_limbs(a)),
                                        jnp.asarray(jflvec.to_limbs(b)))[None])
    edge = a[:3] + [0, 1, L - 1]
    other = [1, 0, L - 1] + b[:3]
    assert fl.limbs_to_ints(flvec.sub(fl.to_limbs(edge),
                                      fl.to_limbs(other))) == \
        [(x - y) % L for x, y in zip(edge, other)]
    assert fl.limbs_to_ints(flvec.neg(fl.to_limbs(edge))) == \
        [-x % L for x in edge]
    vecs = [a, b, [0] * 4 + [L - 1] * 5]
    got = flvec.digits_t_stacked(fl.to_limbs(
        [v for vec in vecs for v in vec]).view(3, 9, fl.NW))
    assert got.dtype == torch.int8 and got.shape == (96, 9)
    assert np.array_equal(got.numpy(),
                          np.asarray(jflvec.digits_t_stacked(vecs)))


# -- flattening ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["bound16", "less_than", "hash"])
def test_flatten_matches_jax_host(name):
    """Device flatten (forced: min_device_terms=0) against the JAX
    package's host loops, prover (wL, wR, wO, wV) and verifier (wc), on
    the same statement assembled by each package; a second call reuses
    the extraction cache."""
    prover = _prepared(prove_prepared, rng, name)
    jprover = _prepared(jax_prove_prepared, jax_rng, name)
    n, m = len(prover.a_L), len(prover.v)
    assert (n, m, len(prover.constraints)) == \
        (len(jprover.a_L), len(jprover.v), len(jprover.constraints))
    z = _rand(4, 1)[0]
    jwL, jwR, jwO, jwV = jprover._flattened_constraints(JaxScalar(z))
    jver = jax_r1cs.Verifier.__new__(jax_r1cs.Verifier)
    jver.constraints, jver.num_vars, jver.V = jprover.constraints, n, [0] * m
    jwc = jver._flattened_constraints(JaxScalar(z))[4]
    flatten._extract_cache.clear()
    for _ in range(2):
        flat = flatten.flatten(prover.constraints, n, m, z, True, "cpu",
                               min_device_terms=0)
        assert flat.ints() == (jwL, jwR, jwO)
        assert (flat.wV, flat.wc) == (jwV, jwc)
        assert len(flatten._extract_cache) == 1
    # the size rule: below MIN_DEVICE_TERMS the caller runs the host loop
    terms = sum(len(lc.terms) for lc in prover.constraints)
    assert (flatten.flatten(prover.constraints, n, m, z, False, "cpu")
            is None) == (terms < flatten.MIN_DEVICE_TERMS)


# -- prover vectors -----------------------------------------------------------

def test_prover_vectors_match_jax_host_branch():
    """ProverVectors.t_poly and lr against the JAX package's host t-poly
    branch (core/r1cs.py), n = 5 padded to 8, with commitment digits and
    the argument's factors."""
    n, padded_n = 5, 8
    aL, aR, aO, sL, sR, wL, wR, wO = (_rand(10 + i, n) for i in range(8))
    y, x, u = _rand(20, 3)
    y_inv = pow(y, L - 2, L)
    S = lambda v: [JaxScalar(s) for s in v]                    # noqa: E731
    jy, jx = JaxScalar(y), JaxScalar(x)
    exp_y = jax_exp_iter(jy, n)
    exp_y_inv = jax_exp_iter(JaxScalar(y_inv), padded_n)
    l1 = [a + e * w for a, e, w in zip(S(aL), exp_y_inv, S(wR))]
    l2, l3 = S(aO), S(sL)
    r0 = [w - e for w, e in zip(S(wO), exp_y)]
    r1 = [e * a + w for e, a, w in zip(exp_y, S(aR), S(wL))]
    r3 = [e * s for e, s in zip(exp_y, S(sR))]
    ip = jax_r1cs._inner
    want_t = [ip(l1, r0), ip(l1, r1) + ip(l2, r0), ip(l2, r1) + ip(l3, r0),
              ip(l1, r3) + ip(l3, r1), ip(l2, r3), ip(l3, r3)]
    xx, xxx = jx * jx, jx * jx * jx
    want_l = [a * jx + b * xx + c * xxx for a, b, c in zip(l1, l2, l3)]
    want_r = [a + b * jx + c * xxx for a, b, c in zip(r0, r1, r3)]
    exp_y_pad = jax_exp_iter(jy, padded_n)
    want_r += [-exp_y_pad[i] for i in range(n, padded_n)]

    wit = prover_device.upload([aL, aR, aO, sL, sR], "cpu")
    pv = prover_device.ProverVectors(*wit, fl.to_limbs(wL), wR, wO, y,
                                     y_inv, padded_n, "cpu")
    assert list(pv.t_poly()) == [v.v % L for v in want_t]
    l_vec, r_vec = pv.lr(x)
    assert fl.limbs_to_ints(l_vec) == [v.v % L for v in want_l] + [0] * 3
    assert fl.limbs_to_ints(r_vec) == [v.v % L for v in want_r]
    g, h = pv.factors(3, u)
    G = [1] * 3 + [u] * 5
    assert fl.limbs_to_ints(fl.from_mont(g)) == G
    assert fl.limbs_to_ints(fl.from_mont(h)) == \
        [gi * e.v % L for gi, e in zip(G, exp_y_inv)]
    blind = _rand(21, 3)
    dig = prover_device.commitment_digits(*wit, blind, padded_n)
    z3 = [0] * 3
    want = [aL + z3 + aR + z3 + [0, blind[0]],
            aO + z3 + [0] * 8 + [0, blind[1]],
            sL + z3 + sR + z3 + [0, blind[2]]]
    assert dig.shape == (96, 2 * padded_n + 2)
    for k in range(3):
        assert _digit_values(dig[32 * k:32 * k + 32].numpy()) == want[k]


# -- verifier scalars ---------------------------------------------------------

def test_table_digits_match_jax():
    """table_digits_dev against the JAX package's table_digits (host
    vectors in, its jitted digit build), n = 5 padded to 8, n1 = 3."""
    n, n1, padded_n = 5, 3, 8
    ynw, wL, wO = (_rand(30 + i, n) for i in range(3))
    y_inv, x, a, b, u, allinv, c_B, c_Bb = _rand(33, 8)
    u_sq = _rand(34, 3)
    want = jverifier_device.table_digits(
        ynw, wL, wO, y_inv, x, a, b, u, allinv, u_sq, n, n1, padded_n, c_B,
        c_Bb)
    got = verifier_device.table_digits_dev(
        fl.to_limbs(ynw), fl.to_limbs(wL), fl.to_limbs(wO),
        flvec.powers_mont(y_inv, padded_n), x, a, b, u, allinv, u_sq, n, n1,
        padded_n, c_B, c_Bb)
    assert got.shape == (32, 2 * padded_n + 2)
    assert _digit_values(got.numpy()) == _digit_values(np.asarray(want))
    # the s-vector itself: s[i] = allinv * prod of u_sq over i's bits
    s = verifier_device._s_vector(flvec.to_mont([allinv])[0],
                                  flvec.to_mont(u_sq))
    want_s = []
    for i in range(padded_n):
        v = allinv
        for j in range(3):
            if i >> j & 1:
                v = v * u_sq[2 - j] % L
        want_s.append(v)
    assert fl.limbs_to_ints(s) == want_s
