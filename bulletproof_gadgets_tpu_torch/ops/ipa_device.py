"""Device helpers of the inner-product argument: the port of the parts of the
JAX package's ops/ipa_device.py that the fused IPA (ops/ipa_fused) uses.

The four coefficient vectors live on the device for the whole argument:
a and b in std form, gc and hc (the collapsed-fold coefficients of the
table's generators inside the current virtual ones) in Montgomery form.
Rows are canonical F_l limbs of ops/fl, [n_full, NW].

Round structure (positions relative to the current virtual length n):
  pos = t mod n;  cross index ga[t] = pos-half if pos >= half else pos+half
  L: G_t gets a[pos-half]*gc[t] when pos >= half, H_t gets b[pos+half]*hc[t]
     when pos < half, B gets c_L*w;  R mirrors with the halves swapped.

`_fold` and `_scalars` also take a group of B proofs of one table on a
leading axis ([B, n_full, NW] rows, u rows [B, 1, NW], wr2 [B, 1, NW]):
the batched IPA (ops/ipa_fused.create_batched) then launches each plain
F_l op once per round for the group, as the JAX package's vmapped round
does.

The digits are the dense [64, m] matrix (L's 32 windows over R's).  The JAX
package's compact layout (`_scalars_compact` and its source `remap`) halves
its TPU entry sort; here the dense layout is kept (the points are the
same): its zero digits sort after the live ones (msm_serial.schedule), and
the L/R structure bounds the live entries (ipa_fused._lr_live), so the
pool is that of the compact layout's entries.
"""
import functools

import numpy as np
import torch

from . import fl, flvec


@functools.lru_cache(maxsize=8)
def round_masks(n_full: int, device="cpu"):
    """Per round (n = n_full, n_full/2, ..., 2), a dict of device tensors:
      ga    [n_full] long: the cross-half gather index (see module doc)
      hi    [n_full, 1] bool: pos >= half
      cs    [n_full] long: shift-by-half gather for c_L / c_R
      lo_i  [n_full, 1] bool: i < half (the rows of c_L)
      hi_i  [n_full, 1] bool: half <= i < n (the rows of c_R)"""
    out = []
    t = np.arange(n_full)
    n = n_full
    while n != 1:
        half = n // 2
        pos = t % n
        hi = pos >= half
        out.append({
            "ga": np.where(hi, pos - half, pos + half),
            "hi": hi[:, None],
            "cs": np.where(t < half, t + half, np.maximum(t - half, 0)),
            "lo_i": (t < half)[:, None],
            "hi_i": ((t >= half) & (t < n))[:, None]})
        n = half
    return [{k: torch.from_numpy(v).to(device) for k, v in m.items()}
            for m in out]


def _fold(a, b, gc, hc, u_m, uinv_m, ga, hi):
    """One dalek fold on full-length rows: a' = a*u + a[ga]*u^-1, b' = b*u^-1
    + b[ga]*u (the rows below half are the folded vector), gc' = gc * (u if
    hi else u^-1), hc' mirrored.  u_m, uinv_m: Montgomery rows [NW] (a
    group: [B, 1, NW] against rows [B, n_full, NW])."""
    return fold_crossed(a, a.index_select(-2, ga), b, b.index_select(-2, ga),
                        gc, hc, u_m, uinv_m, hi)


def fold_crossed(a, a_x, b, b_x, gc, hc, u_m, uinv_m, hi):
    """`_fold` with the cross rows a_x = a[ga], b_x = b[ga] given (the
    sharded argument brings them from the rank that holds them)."""
    fg = torch.where(hi, u_m, uinv_m)
    fh = torch.where(hi, uinv_m, u_m)
    prod = fl.mont_mul(
        torch.stack([a, a_x, b, b_x, gc, hc]),
        torch.stack([u_m.expand_as(fg), uinv_m.expand_as(fg),
                     uinv_m.expand_as(fg), u_m.expand_as(fg), fg, fh]))
    sums = fl.add(prod[0:4:2], prod[1:4:2])
    return sums[0], sums[1], prod[4], prod[5]


def round_terms(a, a_x, b_x, b_c, gc, hc, lo_i, hi_i):
    """A round's products and sums over the rows given: prod_a = a_x * gc,
    prod_b = b_x * hc (Montgomery factors: std results), and sums [2, ...,
    NW], the sums of a * b_c / R over the lo_i rows (c_L's) and the hi_i
    rows (c_R's); b_c = b[cs]."""
    prod_a, prod_b, p1 = fl.mont_mul(torch.stack([a_x, b_x, a]),
                                     torch.stack([gc, hc, b_c]))
    zero = torch.zeros_like(p1)
    sums = flvec.sum_rows(torch.stack([torch.where(lo_i, p1, zero),
                                       torch.where(hi_i, p1, zero)]))
    return prod_a, prod_b, sums


def lr_rows(prod_a, prod_b, hi, c=None):
    """The L vector's rows over the R vector's, [..., 2m, NW]: G rows
    then H rows, then (with c = (c_L * w, c_R * w) rows [..., 1, NW]) the B
    and B_blinding rows."""
    zero = torch.zeros_like(prod_a)
    v_l = [torch.where(hi, prod_a, zero), torch.where(hi, zero, prod_b)]
    v_r = [torch.where(hi, zero, prod_a), torch.where(hi, prod_b, zero)]
    if c is not None:
        tail = torch.zeros_like(c[0])
        v_l += [c[0], tail]
        v_r += [c[1], tail]
    return torch.cat([torch.cat(v_l, dim=-2), torch.cat(v_r, dim=-2)],
                     dim=-2)


def _scalar_rows(a, b, gc, hc, wr2, mk):
    """[..., 2m, NW] std rows (m = 2*n_full + 2): the L vector over the R
    vector.  wr2 = w * R^2 (std row [NW], a group's [B, 1, NW]), so
    mont_mul(c / R, wr2) = c * w."""
    ga = mk["ga"]
    prod_a, prod_b, sums = round_terms(
        a, a.index_select(-2, ga), b.index_select(-2, ga),
        b.index_select(-2, mk["cs"]), gc, hc, mk["lo_i"], mk["hi_i"])
    # c_L * w, c_R * w as [..., 1, NW] rows
    return lr_rows(prod_a, prod_b, mk["hi"],
                   fl.mont_mul(sums.unsqueeze(-2), wr2).unbind(0))


def lr_digits(rows):
    """lr_rows' rows [..., 2m, NW] -> the L and R MSM scalars as signed
    c = 8 digits, int8 [2*32, m] (L's windows, then R's); for a group of B
    proofs [B*2*32, m], proof by proof."""
    dig = flvec.digits_device(rows)
    m = dig.shape[-1] // 2                       # dig [32, (B,) 2m]
    return dig.reshape(32, -1, 2, m).permute(1, 2, 0, 3).reshape(-1, m) \
        .contiguous()


def _scalars(a, b, gc, hc, wr2, mk):
    """This round's L and R MSM scalars as signed c = 8 digits, int8
    [2*32, m] (L's windows, then R's; m = 2*n_full + 2); for a group of B
    proofs [B*2*32, m], proof by proof."""
    return lr_digits(_scalar_rows(a, b, gc, hc, wr2, mk))
