"""The plain reference: its PyTorch field and point arithmetic against
Python integers and the host Ristretto code, and its verifier against the
port's proofs (valid ones pass, altered ones fail)."""
import hashlib
import random

import pytest
import torch

from reference.core import curve_torch as ct
from reference.core.ristretto import RistrettoPoint, P
from reference.core.scalar import L
from reference.lang.verify import verify_many

K = ct.Consts(torch.device("cpu"))


def test_field_ops():
    rnd = random.Random(1)
    a = [rnd.randrange(P) for _ in range(40)] + [0, 1, P - 1, P - 2, 19]
    b = [rnd.randrange(P) for _ in range(len(a))]
    A, B = ct.to_limbs(a, "cpu"), ct.to_limbs(b, "cpu")
    prod = ct.mul(A, B)
    assert ct.to_ints(prod) == [x * y % P for x, y in zip(a, b)]
    assert int(prod.max()) < 1 << 17
    assert ct.to_ints(ct.sub(K, A, B)) == [(x - y) % P for x, y in zip(a, b)]
    c = ct.canon(prod)
    assert ct.to_ints(c) == [x * y % P for x, y in zip(a, b)]
    assert int(c.max()) < 1 << 16


def test_canon_edges():
    vals = [P - 1, P, P + 1, 2**256 - 1, 2 * P - 1, 0, 19, 2**255]
    raw = torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(16)]
                        for v in vals], dtype=torch.int64)
    got = [sum(int(x) << (16 * i) for i, x in enumerate(row))
           for row in ct.canon(raw)]
    assert got == [v % P for v in vals]


def test_generators_match_host():
    stream = hashlib.shake_256(b"GeneratorsChain" + b"G" + bytes(4)).digest(
        64 * 8)
    pts = ct.from_uniform_bytes(K, stream)
    got = [RistrettoPoint(*v) for v in zip(*(ct.to_ints(c) for c in pts))]
    ref = [RistrettoPoint.from_uniform_bytes(stream[64 * i:64 * i + 64])
           for i in range(8)]
    assert [g.compress() for g in got] == [r.compress() for r in ref]
    G, H = ct.generators(K, 2)
    assert RistrettoPoint(*(ct.to_ints(c)[0] for c in G)) == ref[0]


def test_msm_matches_host():
    rnd = random.Random(3)
    stream = hashlib.shake_256(b"x").digest(64 * 21)
    pts = ct.from_uniform_bytes(K, stream)
    ref = [RistrettoPoint.from_uniform_bytes(stream[64 * i:64 * i + 64])
           for i in range(21)]
    sc = [rnd.randrange(L) for _ in range(19)] + [0, L - 1]
    got = RistrettoPoint(*ct.msm(K, sc, pts, chunk=8))
    acc = RistrettoPoint.identity()
    for s, r in zip(sc, ref):
        acc = acc + r.scalar_mul(s)
    assert got == acc


@pytest.fixture(scope="module")
def bound16_proofs():
    from bulletproof_gadgets_tpu_torch.lang.batch import prove_batch
    from bulletproof_gadgets_tpu_torch.utils import rng
    rng.set_seed("benchmark-reference-test")
    inst = "I0 = 0x0010\nI1 = 0x1000\n"
    gadgets = "BOUND W0 I0 I1\n"
    out = prove_batch("bound16", inst, ["W0 = 0x0539\n", "W0 = 0x0fff\n"],
                      gadgets, device="cpu")
    rng.set_seed(None)
    return [("bound16", inst, p, c, gadgets) for p, _, c in out]


def test_verifier_judges_the_ports_proofs(bound16_proofs):
    from harness.traffic import tamper
    good = bound16_proofs
    bad = [good[0][:2] + (tamper(good[0][2]),) + good[0][3:]]
    wrong_name = [("other",) + good[1][1:]]
    wrong_com = [good[1][:3] + (good[0][3],) + good[1][4:]]
    verdicts = verify_many(good + bad + wrong_name + wrong_com, "cpu",
                           b"test")
    assert verdicts == [True, True, False, False, False]
    assert verify_many([good[0][:2] + (b"\x00" * 7,) + good[0][3:]],
                       "cpu", b"t") == [False]
