"""Limb bounds of the port's field layout (ops/fp, csrc/field.cuh).

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
