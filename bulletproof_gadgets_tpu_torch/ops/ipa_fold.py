"""The IPA table fold on the device: the port of the JAX package's
ops/ipa_fold.py.

The fused IPA (ops/ipa_fused) never moves the generators: after d rounds the
virtual generator G'_i is sum_{k < 2^d} gc[i + k*n'] * G[i + k*n'] (n' =
n / 2^d), and every round's L/R is an MSM over the whole table.  Every
FOLD_AT rounds, while the folded table keeps at least FOLD_MIN generators,
the folded table is materialized instead: n' outputs per half (G and H),
each a 2^d-term multi-scalar ladder, and the rounds after it run over a
table 2^d times smaller.

  digits    the coefficients (Montgomery) -> std -> 64 signed 4-bit windows
            per term, on the device (`digits4_dev`, the +0x88..8 bias of
            ops/flvec.windows, no carry chain over the windows);
  K6        `ladder_fold`: per output, the multiples 1P..8P of its 2^d
            points in cached form, O = sum over 64 signed 4-bit windows of
            the 2^d selected multiples, then the Z inversion to canonical
            affine source rows and their negations;
  assemble  the new source rows [G' | H' | B | Bb | negs | identity] in the
            ops/msm_serial.prep_source layout.

The fold parameters are module constants and arguments of ipa_fused.create,
not environment knobs.  The JAX package cuts a fold into slabs of <= 2^17
ladder terms to bound TPU memory; here one launch folds both halves (each
output's multiples live in the kernel's shared memory).
"""
import torch

from . import curve, fl, flvec, fp
from .msm_serial import NL, ROW
from .. import native

FOLD_AT = 4          # fold every 4 rounds of a segment ...
FOLD_MIN = 512       # ... while the folded table keeps >= 512 generators
MAX_TERMS = 32       # K6 takes folds of 2^d <= 32 terms (its shared memory)


def digits4_dev(std_rows):
    """[..., NW] canonical std rows -> [64, ...] int32 windows e_w in
    [0, 15]; the ladder's signed digit is e_w - 8."""
    return flvec.windows(std_rows, 4).to(torch.int32)


# ---------------------------------------------------------------------------
# K6: the fold ladder

def ladder_fold(src, base, dig):
    """src int32 [S, ROW] affine rows; base int32 [K, n]: the source row of
    term k of output lane i; dig int32 [64*K, n]: row w*K + k holds window
    w (0..15, digit e - 8) of term k's scalar -> int32 [2, n, ROW]: the
    canonical affine rows (x | y | 2d*x*y | 0 0) of O_i = sum_k s_ki P_ki,
    then the rows of -O_i.

    Replaces bulletproof_gadgets_tpu/ops/ipa_fold.py:_ladder_kernel and
    the XLA around it in _mat_slab (multiples, Z inversion).  Bound on the
    H100: latency — one output's ladder is ~1,410 dependent point
    operations if one thread runs it, and a fold has only n = 2,048
    (2^14 gens) to 8,192 (2^16) outputs.  Design (csrc/ipa_fold.cu): one
    warp per output, its terms' multiples in shared memory; lane j sums
    windows 2j+1 and 2j over the terms, then the warp joins the 32
    partials by Horner and inverts Z, each field product spread over 8
    lanes.  Outputs are canonical rows, so the plain version's one-lane
    ladder gives the same bytes.  Folds of more than MAX_TERMS terms raise
    ValueError (on every device: one specification)."""
    native.check(src, "src", (None, ROW))
    native.check(base, "base", (None, None))
    k, n = base.shape
    native.check(dig, "dig", (64 * k, n))
    if not 1 <= k <= MAX_TERMS:
        raise ValueError(f"ladder_fold: {k} terms, the kernel takes 1.."
                         f"{MAX_TERMS}")
    lib = native.kernels_for(src, base, dig)
    if lib is None:
        return ladder_fold_plain(src, base, dig)
    out = torch.empty((2, n, ROW), dtype=torch.int32, device=src.device)
    if n == 0:
        return out
    native.launched("ladder_fold", lib.bpg_ladder_fold(
        src.data_ptr(), base.data_ptr(), dig.data_ptr(), k, n,
        out.data_ptr(), native.stream(src)))
    return out


def _multiples(x, y, t2d):
    """Cached forms of 1P..8P of affine points (x, y, t2d = 2d*x*y), each
    [NL, ...]: the kernel's sequence (dbl and madd with the affine row)."""
    one = torch.zeros_like(x)
    one[0] = 1
    row = (x, y, t2d)
    p1 = (x, y, one, None)                       # T unused by dbl
    p2 = curve.dbl(p1)
    p3 = curve.madd(p2, row)
    p4 = curve.dbl(p2)
    p5 = curve.madd(p4, row)
    p6 = curve.dbl(p3)
    p7 = curve.madd(p6, row)
    p8 = curve.dbl(p4)
    first = (fp.sub(y, x), fp.add(y, x), fp.add(one, one), t2d)
    return [first] + [curve.to_cached(p) for p in (p2, p3, p4, p5, p6, p7,
                                                    p8)]


def affine_rows(pt):
    """Extended points [NL, n] -> int32 [2, n, ROW]: canonical x | y |
    2d*x*y rows of the points and of their negations."""
    x, y, z, _ = pt
    zinv = curve.inv_fp(z)
    ax, ay = fp.mul_many([x, y], [zinv, zinv])
    at2d = fp.mul(fp.mul(ax, ay), fp.d2_like(ax))
    pad = torch.zeros((2, ax.shape[1]), dtype=torch.int64, device=ax.device)
    rows = [torch.cat([fp.canonical(a) for a in c] + [pad]).t()
            for c in ((ax, ay, at2d), (fp.neg(ax), ay, fp.neg(at2d)))]
    return torch.stack(rows).to(torch.int32).contiguous()


def ladder_fold_plain(src, base, dig):
    """ladder_fold in plain PyTorch, vectorized over outputs: the
    one-thread Straus ladder (64 windows high to low, 4 doublings, then
    one select-and-add per term).  Its rows are canonical, so they equal
    the kernel's, whose adds run in another order."""
    if bool(((base < 0) | (base >= src.shape[0])).any()):
        raise ValueError("base: row index outside src")
    if bool(((dig < 0) | (dig > 15)).any()):
        raise ValueError("dig: window outside 0..15")
    k_terms, n = base.shape
    rows = src.to(torch.int64)[base.long()].permute(2, 0, 1)   # [ROW, K, n]
    mult = torch.stack([torch.stack(c) for c in _multiples(
        rows[0:NL], rows[NL:2 * NL], rows[2 * NL:3 * NL])])  # [8,4,NL,K,n]
    ident = torch.stack(curve.to_cached(curve.identity((n,), src.device)))
    acc = curve.identity((n,), src.device)
    dig = dig.long().view(64, k_terms, n)
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = curve.dbl(acc)
        for k in range(k_terms):
            e = dig[w, k]
            a = (e - 8).abs()
            pick = (a - 1).clamp(min=0).view(1, 1, 1, n).expand(1, 4, NL, n)
            sel = mult[:, :, :, k].gather(0, pick)[0]           # [4, NL, n]
            sel = torch.where(a == 0, ident, sel)
            d, s, z2, t2d = sel.unbind(0)
            neg = e < 8
            sel = (torch.where(neg, s, d), torch.where(neg, d, s), z2,
                   torch.where(neg, fp.neg(t2d), t2d))
            acc = curve.padd_cached(acc, sel)
    return affine_rows(acc)


# ---------------------------------------------------------------------------
# materialization

def _mat_slab(src, coeffs, o_lo: int, n_t: int, d: int, o_n: int,
              half_offs):
    """Outputs i in [o_lo, o_lo + o_n) of O_i = sum_k coeff[i + k*n'] *
    P[half_off + i + k*n'] (n' = n_t >> d), for each (coeff, half_off)
    pair, lanes concatenated in that order.  coeffs: Montgomery rows
    [n_t, NW]; src: rows [S, ROW].  Returns (rows, neg_rows), each int32
    [len(half_offs) * o_n, ROW]."""
    k_terms = 1 << d
    lane = torch.arange(o_lo, o_lo + o_n, device=src.device)
    term = (torch.arange(k_terms, device=src.device)[:, None]
            * (n_t >> d) + lane)                                # [K, o_n]
    base = torch.cat([term + off for off in half_offs], 1).to(torch.int32)
    std = fl.from_mont(torch.cat([c[term] for c in coeffs], 1))  # [K,n,NW]
    dig = digits4_dev(std).reshape(64 * k_terms, -1).contiguous()
    out = ladder_fold(src, base.contiguous(), dig)
    return out[0], out[1]


def _assemble(rows, neg_rows, old_src, m_old: int):
    """New source [G' | H' | B | Bb | -G' | -H' | -B | -Bb | identity] from
    the folded rows [G' | H'] and their negations; B and B_blinding (and
    the identity) keep their rows of the old source."""
    n_t_old = (m_old - 2) // 2
    b = old_src[2 * n_t_old:2 * n_t_old + 2]
    b_neg = old_src[m_old + 2 * n_t_old:m_old + 2 * n_t_old + 2]
    ident = old_src[2 * m_old:2 * m_old + 1]
    return torch.cat([rows, b, neg_rows, b_neg, ident]).contiguous()


def materialize(src, gc, hc, n_t: int, d: int, m_old: int):
    """Fold the device table 2^d-fold with the collapsed coefficients
    (after the pending challenge fold was applied to gc/hc).  src: rows
    [2*m_old+1, ROW] over [G | H | B | Bb]; gc/hc: Montgomery rows
    [n_t, NW].  Returns the rows of [G' | H' | B | Bb], n' = n_t >> d."""
    rows, negs = _mat_slab(src, (gc, hc), 0, n_t, d, n_t >> d, (0, n_t))
    return _assemble(rows, negs, src, m_old)
