"""Limb bounds of the port's field layouts: the 10-limb core (ops/fp,
csrc/field.cuh) and the radix-2^32 core of the bucket accumulation
(csrc/field32.cuh).

Runs interval arithmetic over the exact op sequences of ops/curve.madd,
padd and dbl, and of the table fold (ops/ipa_fold, csrc/ipa_fold.cu:
multiples, cached forms and their negations, padd_cached, the tree's
unified adds, the inversion's squarings) — the same functions, given an
interval field — and proves, for any input values:
  * no int64 overflows: each 32x32 -> 64-bit product (times 2 for odd*odd
    limbs, times 19 for wrapped columns in the plain version), each column
    sum (its sum of |terms| bounds d_k, 19*w_k, h_k = d_k + 19*w_k and
    every partial sum in any order), and every step of the rounding carry;
  * no int32 overflows where the kernels keep limbs in int32: carried
    limbs, the lazy sums and differences fed to fe_mul, and 2*f for odd
    limbs;
  * the carried limb bound sustains itself: starting from canonical limbs
    (table rows, the identity), the hull of everything madd, padd and dbl
    produce reaches a fixed point, and it is inside canonical()'s input
    range.
The hull starts from canonical limbs, and that covers every 10-limb input
the kernels see: table rows; K3's input, the pool, which K1, K2 and K8-K10
write as canonical limbs; and K2's and K9's carried pools, which are that
pool (their plain versions reject limbs outside [0, 2^w)) and which their
radix-2^32 core reads by shifts, not through fe_mul.  The radix-2^32 core
itself is modelled instruction for instruction at the end of this file.
The JAX package's tests/test_pallas_curve.py does the same for the 13-bit
TPU layout.
"""
from bulletproof_gadgets_tpu_torch.ops import curve, fp

I32 = (-(1 << 31), (1 << 31) - 1)
I64 = (-(1 << 63), (1 << 63) - 1)


def _fits(lo, hi, rng, what):
    assert rng[0] <= lo and hi <= rng[1], (what, lo, hi)


class IntervalField:
    """A field element is a tuple of NL (lo, hi) limb intervals."""

    NL = fp.NL

    def __init__(self):
        self.max_abs = {"lazy32": 0, "prod64": 0, "col64": 0}

    def _lazy(self, r):
        for lo, hi in r:
            _fits(lo, hi, I32, "lazy limb in int32")
            self.max_abs["lazy32"] = max(self.max_abs["lazy32"], -lo, hi)
        return tuple(r)

    def add(self, a, b):
        return self._lazy([(x[0] + y[0], x[1] + y[1]) for x, y in zip(a, b)])

    def sub(self, a, b):
        return self._lazy([(x[0] - y[1], x[1] - y[0]) for x, y in zip(a, b)])

    def neg(self, a):
        return self._lazy([(-x[1], -x[0]) for x in a])

    def d2_like(self, _):
        return tuple((v, v) for v in fp.D2)

    def mul_many(self, fs, gs):
        return [self.mul(f, g) for f, g in zip(fs, gs)]

    def mul(self, f, g):
        n = self.NL
        d = [(0, 0)] * n
        w = [(0, 0)] * n                    # w[n-1] stays 0: no wrap into 9
        mag = [0] * n                       # sum of |terms| per column
        for i in range(n):
            fi = f[i]
            if i & 1:                       # the kernel's int32 2*f_i
                _fits(2 * fi[0], 2 * fi[1], I32, "2*f in int32")
            for j in range(n):
                k = 2 if (i & 1) and (j & 1) else 1
                cands = [k * a * b for a in fi for b in g[j]]
                p = (min(cands), max(cands))
                wraps = i + j >= n
                # the plain version multiplies f*g by the factor k*19^wraps
                big = max(-p[0], p[1]) * (19 if wraps else 1)
                _fits(-big, big, I64, "product in int64")
                self.max_abs["prod64"] = max(self.max_abs["prod64"], big)
                col = (i + j) % n
                mag[col] += big
                acc = w if wraps else d
                acc[col] = (acc[col][0] + p[0], acc[col][1] + p[1])
        h = []
        for k in range(n):
            # any partial sum, in any order, of either version's terms
            _fits(-mag[k], mag[k], I64, "column sum in int64")
            self.max_abs["col64"] = max(self.max_abs["col64"], mag[k])
            h.append((d[k][0] + 19 * w[k][0], d[k][1] + 19 * w[k][1]))
        return self.carry(h)

    @staticmethod
    def carry(h):
        """Rounding carries in fp.CARRY_ORDER over limb intervals."""
        h = [list(x) for x in h]
        for i in fp.CARRY_ORDER:
            w = fp.W[i]
            half = 1 << (w - 1)
            lo, hi = h[i]
            _fits(lo + half, hi + half, I64, "carry input in int64")
            c = ((lo + half) >> w, (hi + half) >> w)
            if c[0] == c[1]:
                h[i] = [lo - (c[0] << w), hi - (c[0] << w)]
            else:
                h[i] = [-half, half - 1]
            tgt, mult = (0, 19) if i == fp.NL - 1 else (i + 1, 1)
            h[tgt] = [h[tgt][0] + mult * c[0], h[tgt][1] + mult * c[1]]
            _fits(h[tgt][0], h[tgt][1], I64, "carry target in int64")
        for lo, hi in h:
            _fits(lo, hi, I32, "carried limb in int32")
        return tuple(tuple(x) for x in h)


def _hull(a, b):
    return tuple((min(x[0], y[0]), max(x[1], y[1])) for x, y in zip(a, b))


def _hull_pt(p, q):
    return tuple(_hull(a, b) for a, b in zip(p, q))


CANON = tuple((0, (1 << w) - 1) for w in fp.W)


def test_carried_bound_is_self_sustaining():
    F = IntervalField()
    state = (CANON,) * 4                     # identity / canonical inputs
    row = (CANON,) * 3                       # table rows x | y | t2d
    for _ in range(20):
        new = _hull_pt(state, curve.madd(state, row, F=F))
        new = _hull_pt(new, curve.padd(new, new, F=F))
        new = _hull_pt(new, curve.dbl(new, F=F))
        if new == state:
            break
        state = new
    else:
        raise AssertionError("no fixed point")
    # the fixed point is the canonical range plus the carry range
    for coord in state:
        for (lo, hi), w in zip(coord, fp.W):
            assert -(1 << (w - 1)) - (1 << 17) <= lo
            assert hi <= (1 << w) - 1
            # canonical() adds 8p limb-wise: inputs need |limb| < 2^28 - 152
            assert max(-lo, hi) < (1 << 28) - 152
    # headroom actually used (documented in ops/fp.py)
    assert F.max_abs["col64"] < 1 << 62
    assert F.max_abs["lazy32"] < 1 << 28


def test_interval_carry_matches_plain_carry():
    """The interval model of the carry is the plain version's carry: limb
    vectors at the interval corners carry to values inside the intervals."""
    import torch
    h = [((-1) ** i * (1 << 60) + i, (1 << 61) - i) for i in range(fp.NL)]
    bounds = IntervalField.carry(h)
    corners = torch.tensor([[lo for lo, _ in h], [hi for _, hi in h]],
                           dtype=torch.int64).t()
    out = fp.carry(corners)
    for i, (lo, hi) in enumerate(bounds):
        assert all(lo <= int(v) <= hi for v in out[i])


def test_fold_sequences_keep_the_bounds():
    """The fold ladder's sequences: the multiples 1P..8P of a canonical
    affine row by dbl and madd, their cached forms (lazy y - x, y + x, 2z;
    carried 2d*t), the negated cached forms, the identity's cached form,
    padd_cached into the accumulator, the unified adds and doublings of
    the lanes' partials in the fold tree, and the inversion's products of
    carried values.  The carried bound reaches a fixed point, every int64
    column sum stays under 2^62, and carried limbs and their negations are
    inside canonical()'s input range."""
    F = IntervalField()
    row = (CANON,) * 3
    one = tuple((1, 1) if i == 0 else (0, 0) for i in range(fp.NL))
    zero = ((0, 0),) * fp.NL
    first = (F.sub(CANON, CANON), F.add(CANON, CANON), F.add(one, one),
             CANON)                               # cached 1P from the row
    ident = curve.to_cached((zero, one, one, zero), F=F)
    state = (CANON, CANON, one, zero)
    for _ in range(20):
        new = _hull_pt(state, curve.dbl(state, F=F))
        new = _hull_pt(new, curve.madd(new, row, F=F))
        cached = curve.to_cached(new, F=F)
        for c in (curve.neg_cached(cached, F=F), first,
                  curve.neg_cached(first, F=F), ident):
            cached = _hull_pt(cached, c)
        new = _hull_pt(new, curve.padd_cached(new, cached, F=F))
        new = _hull_pt(new, curve.padd(new, new, F=F))     # fold tree
        new = tuple(_hull(c, F.mul(c, c)) for c in new)    # inversion
        if new == state:
            break
        state = new
    else:
        raise AssertionError("no fixed point")
    for coord in state:
        for lo, hi in coord:
            assert max(-lo, hi) < (1 << 28) - 152        # also negated
    assert F.max_abs["col64"] < 1 << 62
    assert F.max_abs["lazy32"] < 1 << 29


# -- the radix-2^32 core of K1, K2 and K8-K10 (csrc/field32.cuh) --------------
#
# A model of the core's PTX, instruction for instruction, on Python ints:
# every result must fit its 32-bit register, plus the carry flag where the
# instruction sets it (.cc); an instruction without .cc that would carry out
# fails.  The model's results are held against Python's (a op b) % p.

M32 = (1 << 32) - 1
P8 = (1 << 255) - 19
P_WORDS = [0xffffffed] + [0xffffffff] * 6 + [0x7fffffff]


class Ptx:
    """The carry flag and the u32 instructions field32.cuh uses; `hits`
    counts the rare carries and borrows (so the tests can show that their
    operands reach them)."""

    def __init__(self):
        self.cf = 0
        self.hits = {"add_wrap2": 0, "sub_borrow2": 0, "mul_fold3": 0,
                     "canonical_sub2": 0}

    def _put(self, v, cc):
        assert 0 <= v < (1 << 33 if cc else 1 << 32), (v, cc)
        if cc:
            self.cf = v >> 32
        return v & M32

    def mad(self, half, a, b, c, cc, carry_in):
        assert 0 <= a <= M32 and 0 <= b <= M32 and 0 <= c <= M32
        p = a * b
        part = p & M32 if half == "lo" else p >> 32
        return self._put(part + c + (self.cf if carry_in else 0), cc)

    def add(self, a, b, cc, carry_in):
        assert 0 <= a <= M32 and 0 <= b <= M32
        return self._put(a + b + (self.cf if carry_in else 0), cc)

    def sub(self, a, b, cc, borrow_in):
        assert 0 <= a <= M32 and 0 <= b <= M32
        v = a - b - (self.cf if borrow_in else 0)
        if cc:
            self.cf = int(v < 0)
            return v & M32
        assert v >= 0, "borrow lost"
        return v

    def borrow_mask(self):                   # subc.u32 c, 0, 0
        return M32 if self.cf else 0


def words(v):
    assert 0 <= v < 1 << 256
    return [(v >> (32 * i)) & M32 for i in range(8)]


def value(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


def fe8_add(m, a, b):
    r = [m.add(a[i], b[i], True, i > 0) for i in range(8)]
    c = m.add(0, 0, False, True) * 38
    r = [m.add(r[i], c if i == 0 else 0, True, i > 0) for i in range(8)]
    c = m.add(0, 0, False, True)
    m.hits["add_wrap2"] += c
    r[0] = m.mad("lo", c, 38, r[0], False, False)
    return r


def fe8_sub(m, a, b):
    r = [m.sub(a[i], b[i], True, i > 0) for i in range(8)]
    c = m.borrow_mask() & 38
    r = [m.sub(r[i], c if i == 0 else 0, True, i > 0) for i in range(8)]
    c = m.borrow_mask() & 38
    m.hits["sub_borrow2"] += c > 0
    r[0] = m.sub(r[0], c, False, False)
    return r


def fe8_chain(m, acc, k, x4, b, mode):
    """acc[k..k+7] += x4[j] * b as word pairs at k + 2j, then the carry
    out of word k+7 added to acc[k+8] ("add"), written there ("set") or
    proved absent ("none")."""
    for j in range(4):
        acc[k + 2 * j] = m.mad("lo", x4[j], b, acc[k + 2 * j], True, j > 0)
        acc[k + 2 * j + 1] = m.mad("hi", x4[j], b, acc[k + 2 * j + 1],
                                   j < 3 or mode != "none", True)
    if mode == "add":
        acc[k + 8] = m.add(acc[k + 8], 0, False, True)
    elif mode == "set":
        acc[k + 8] = m.add(0, 0, False, True)


def fe8_mul(m, a, b):
    E, O = [0] * 16, [0] * 16
    for j in range(0, 8, 2):                 # row 0: no addend, no carry
        E[j], E[j + 1] = (a[j] * b[0]) & M32, (a[j] * b[0]) >> 32
        O[j + 1], O[j + 2] = (a[j + 1] * b[0]) & M32, (a[j + 1] * b[0]) >> 32
    for i in range(1, 8):
        o = i & 1
        fe8_chain(m, E, i + o, a[o::2], b[i], "add" if i < 7 else "none")
        fe8_chain(m, O, i + 1 - o, a[1 - o::2], b[i], "add")
    assert value(E) + value(O) == value(a) * value(b)
    return fe8_fold(m, E, O)


def fe8_fold(m, E, O):
    """E + O (O[0] = 0) -> 8 words < 2^256, equal mod p."""
    assert O[0] == 0
    fe8_chain(m, E, 0, E[8::2], 38, "set")
    fe8_chain(m, E, 0, O[8::2], 38, "add")
    odd_hi = E[9::2], O[9::2]
    O[8] = 0
    fe8_chain(m, O, 1, odd_hi[0], 38, "none")
    fe8_chain(m, O, 1, odd_hi[1], 38, "none")
    r = [E[0]] + [m.add(E[i], O[i], True, i > 1) for i in range(1, 8)]
    c = m.add(E[8], O[8], False, True)
    assert c <= 39                           # r < 40 * 2^256
    c = m.mad("lo", c, 38, 0, False, False)  # mul.lo
    r = [m.add(r[i] if i else E[0], c if i == 0 else 0, True, i > 0)
         for i in range(8)]
    c = m.add(0, 0, False, True)
    m.hits["mul_fold3"] += c
    r[0] = m.mad("lo", c, 38, r[0], False, False)
    return r


def fe8_chain_n(m, acc, k, xs, b):
    """fe8_chain3/2/1: acc[k..k+2n-1] += xs[j] * b at k + 2j, then the
    carry out added to acc[k + 2n]."""
    for j, x in enumerate(xs):
        acc[k + 2 * j] = m.mad("lo", x, b, acc[k + 2 * j], True, j > 0)
        acc[k + 2 * j + 1] = m.mad("hi", x, b, acc[k + 2 * j + 1], True,
                                   True)
    acc[k + 2 * len(xs)] = m.add(acc[k + 2 * len(xs)], 0, False, True)


def fe8_sqr(m, a):
    E, O = [0] * 16, [0] * 16
    for j in range(1, 8):                    # row 0: no addend, no carry
        acc = O if j & 1 else E
        acc[j], acc[j + 1] = (a[0] * a[j]) & M32, (a[0] * a[j]) >> 32
    for acc, k, js, i in ((O, 3, (2, 4, 6), 1), (E, 4, (3, 5, 7), 1),
                          (O, 5, (3, 5, 7), 2), (E, 6, (4, 6), 2),
                          (O, 7, (4, 6), 3), (E, 8, (5, 7), 3),
                          (O, 9, (5, 7), 4), (E, 10, (6,), 4),
                          (O, 11, (6,), 5), (E, 12, (7,), 5),
                          (O, 13, (7,), 6)):
        assert all(k + 2 * n == i + j for n, j in enumerate(js))
        fe8_chain_n(m, acc, k, [a[j] for j in js], a[i])
    cross = sum(a[i] * a[j] << (32 * (i + j)) for i in range(8)
                for j in range(i + 1, 8))
    assert value(E) + value(O) == cross
    for acc in (E, O):                       # funnel shifts: x 2
        assert acc[15] >> 31 == 0
        acc[:] = [(acc[0] << 1) & M32] + [
            ((acc[k] << 1) | (acc[k - 1] >> 31)) & M32 for k in range(1, 16)]
    for i in range(8):                       # the squares on E's pairs
        E[2 * i] = m.mad("lo", a[i], a[i], E[2 * i], True, i > 0)
        E[2 * i + 1] = m.mad("hi", a[i], a[i], E[2 * i + 1], i < 7, True)
    assert value(E) + value(O) == value(a) ** 2
    return fe8_fold(m, E, O)


def fe8_sub_p_if_ge(m, a):
    d = [m.sub(a[i], P_WORDS[i], True, i > 0) for i in range(8)]
    return a if m.borrow_mask() else d


def fe8_to_canonical_limbs(m, a):
    once = fe8_sub_p_if_ge(m, a)
    c = fe8_sub_p_if_ge(m, once)
    m.hits["canonical_sub2"] += c is not once
    v = value(c)
    assert v < P8
    return [(v >> s) & ((1 << w) - 1) for s, w in zip(fp.S, fp.W)]


def fe8_from_limbs(limbs):
    l = limbs
    assert all(0 <= x < 1 << w for x, w in zip(l, fp.W))
    return [(l[0] | (l[1] << 26)) & M32,
            ((l[1] >> 6) | (l[2] << 19)) & M32,
            ((l[2] >> 13) | (l[3] << 13)) & M32,
            ((l[3] >> 19) | (l[4] << 6)) & M32,
            (l[5] | (l[6] << 25)) & M32,
            ((l[6] >> 7) | (l[7] << 19)) & M32,
            ((l[7] >> 13) | (l[8] << 12)) & M32,
            ((l[8] >> 20) | (l[9] << 6)) & M32]


def _edge_operands():
    """Worst cases for the core (the largest lazy value, p and its
    neighbours, 0) and operands that reach the rare carries: with b =
    2^256 - 1 and a = 36 / 37 mod 2^256 the product's first fold leaves
    2^256 - 2 beside a carry word, so the second fold carries out."""
    top = (1 << 256) - 1
    fold3 = 36 * pow(37, -1, 1 << 256) % (1 << 256)
    return [0, 1, 19, 38, P8 - 1, P8, P8 + 1, 2 * P8 - 1, 2 * P8, top,
            top - 37, (1 << 255) - 1, 1 << 255, (1 << 224) - 1, M32, fold3]


def _operand_pairs():
    import random
    r = random.Random(32)
    edge = _edge_operands()
    pairs = [(a, b) for a in edge for b in edge]
    pairs += [(r.randrange(1 << 256), r.randrange(1 << 256))
              for _ in range(300)]
    return pairs


def test_field32_model_matches_python_ints():
    """fe8_mul, fe8_add, fe8_sub and the final reduction of
    csrc/field32.cuh, modelled instruction for instruction, on edge and
    seeded random operands < 2^256: each result is < 2^256 (8 words) and
    equal mod p to (a op b) % p, no instruction needs more than its 32-bit
    word and the carry flag, and the rare carries (a second wrap of an add,
    a second borrow of a sub, the product's last fold, a second subtraction
    of p) are all reached."""
    m = Ptx()
    for a, b in _operand_pairs():
        wa, wb = words(a), words(b)
        for op, want in ((fe8_mul, a * b), (fe8_add, a + b),
                         (fe8_sub, a - b)):
            got = value(op(m, wa, wb))
            assert got < 1 << 256 and got % P8 == want % P8, (op, a, b)
        limbs = fe8_to_canonical_limbs(m, wa)
        assert limbs == fp.int_to_limbs(a)
        assert value(fe8_from_limbs(limbs)) == a % P8
    assert all(m.hits.values()), m.hits


def test_field32_sqr_model_matches_python_ints():
    """fe8_sqr of csrc/field32.cuh, modelled instruction for instruction
    on the edge and seeded operands: each square is < 2^256 and equal mod
    p to a^2 (and to fe8_mul(a, a) mod p), no instruction needs more than
    its 32-bit word and the carry flag (the rows' carry words included),
    and the fold's rare last carry is reached."""
    import random
    r = random.Random(36)
    m = Ptx()
    top = (1 << 256) - 1
    # the fold's last carry: squares of 2^256 - 1 - k for small k (51 of
    # these 64 reach it; no random operand does)
    ops = _edge_operands() + [top - k for k in range(64)] + [
        r.randrange(1 << 256) for _ in range(2000)]
    for a in ops:
        got = value(fe8_sqr(m, words(a)))
        assert got < 1 << 256 and got % P8 == a * a % P8, a
    assert m.hits["mul_fold3"], m.hits


def test_field32_madd_model_matches_plain_madd():
    """ge8_madd (csrc/field32.cuh) on the model, from canonical limbs in
    and to canonical limbs out as the kernels run it, against the plain
    version's curve.madd followed by fp.canonical, over a few rounds from
    the identity and from edge-valued accumulators."""
    import random
    r = random.Random(33)
    edge = _edge_operands()
    m = Ptx()

    def madd8(p, x2, y2, t2d):
        X, Y, Z, T = p
        a = fe8_mul(m, fe8_sub(m, Y, X), fe8_sub(m, y2, x2))
        b = fe8_mul(m, fe8_add(m, Y, X), fe8_add(m, y2, x2))
        c = fe8_mul(m, T, t2d)
        d = fe8_add(m, Z, Z)
        e, f, g, h = (fe8_sub(m, b, a), fe8_sub(m, d, c), fe8_add(m, d, c),
                      fe8_add(m, b, a))
        return (fe8_mul(m, e, f), fe8_mul(m, g, h), fe8_mul(m, f, g),
                fe8_mul(m, e, h))

    lanes = 6
    starts = [[0, 1, 1, 0]] + [[edge[(i * 4 + c) % len(edge)] % P8
                                for c in range(4)] for i in range(lanes - 1)]
    rows = [[[r.choice(edge + [r.randrange(P8)]) % P8 for _ in range(3)]
             for _ in range(lanes)] for _ in range(3)]
    acc8 = [tuple(fe8_from_limbs(fp.int_to_limbs(v)) for v in s)
            for s in starts]
    for rnd in rows:
        acc8 = [madd8(p, *(fe8_from_limbs(fp.int_to_limbs(v)) for v in row))
                for p, row in zip(acc8, rnd)]
    got = [[fe8_to_canonical_limbs(m, c) for c in p] for p in acc8]
    import numpy as np
    import torch
    acc = tuple(torch.from_numpy(fp.ints_to_limbs([s[c] for s in starts])
                                 .astype(np.int64)) for c in range(4))
    for rnd in rows:
        acc = curve.madd(acc, tuple(
            torch.from_numpy(fp.ints_to_limbs([row[c] for row in rnd])
                             .astype(np.int64)) for c in range(3)))
    want = [fp.canonical(c) for c in acc]
    for lane in range(lanes):
        for c in range(4):
            assert got[lane][c] == [int(v) for v in want[c][:, lane]]
