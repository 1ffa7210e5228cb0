"""Ristretto255 compression and the challenge's F_l steps on torch tensors:
the port of the JAX package's ops/ristretto_device.py.

  * ristretto_compress (kernel, csrc/ristretto.cu) and its plain version
    compress_cols: MSM results [4, NL, k] (ops/fp limbs, any carried
    values) -> [k, 32] uint8 RFC 9496 encodings, the steps of
    core/ristretto.RistrettoPoint.compress; the inverse square root's
    (p-5)/8 = 2^252 - 3 power runs the curve25519 addition chain (251
    squarings, 11 products; the JAX package's bit ladder takes ~500
    products for the same value).  Limbs are canonicalized by
    ops/fp.canonical; `canonical_bytes` writes them as bytes.
  * points_from_uniform_bytes: RistrettoPoint::from_uniform_bytes for a
    batch of 64-byte strings (the generator chains of core/gens at large
    capacities): two elligator maps (sqrt_ratio_m1 below) and one
    ops/curve.padd per string, the formulas of core/ristretto, so the
    points' coordinates equal the host's exactly.
  * challenge_limbs: the transcript's 64 challenge bytes -> the std F_l row
    of their value mod l (Scalar::from_bytes_mod_order_wide);
    to_mont_dev, inv_mont: its Montgomery row and that of its inverse
    (u^(l-2) by 4-bit windows, as the JAX package's inv_mont; the kernel
    inverts by divsteps instead, to the same canonical row).  All
    rows are canonical ops/fl rows, so they equal flvec.to_mont of the
    host's values limb for limb.  These are the plain version of the F_l
    part of the transcript kernel (ops/strobe_device.transcript_round).

ristretto_compress counts its launches in native.LAUNCHES
["ristretto_compress"]; CPU tensors take the plain version.  Oracles:
core/ristretto.py and Python ints (tests/test_torch_ristretto_device.py).
"""
import functools

import numpy as np
import torch

from . import curve, fl, fp
from .. import native
from ..core.ristretto import (D, D_MINUS_ONE_SQ, INVSQRT_A_MINUS_D,
                              ONE_MINUS_D_SQ, P, SQRT_AD_MINUS_ONE, SQRT_M1,
                              RistrettoPoint)
from ..core.scalar import L

NL = fp.NL


@functools.lru_cache(maxsize=None)
def _byte_plan(device):
    """For byte j of a canonical value: the limb holding its lowest bit,
    that bit's offset in it, and the next limb's shift into the byte (limb
    NL, past the top, is a zero row)."""
    lo, off, nxt = [], [], []
    for j in range(32):
        i = max(i for i in range(NL) if fp.S[i] <= 8 * j)
        lo.append(i)
        off.append(8 * j - fp.S[i])
        nxt.append(fp.S[i + 1] - 8 * j if i + 1 < NL else 0)
    t = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return t(lo), t(off)[:, None], t(nxt)[:, None]


def canonical_bytes(xc):
    """Canonical limbs int64 [NL, k] -> uint8 [k, 32], little-endian."""
    lo, off, nxt = _byte_plan(xc.device)
    ext = torch.cat([xc, torch.zeros_like(xc[:1])])
    b = ((ext[lo] >> off) | (ext[lo + 1] << nxt)) & 0xFF
    return b.t().to(torch.uint8).contiguous()


def _is_negative(x):
    """dalek's is_negative: the canonical value is odd -> bool [k]."""
    return (fp.canonical(x)[0] & 1).bool()


def _eq(a, b):
    return (fp.canonical(a) == fp.canonical(b)).all(0)


def _const(value, like):
    return fp.const(fp.int_to_limbs(value), like)


def _abs(x):
    """The canonical value of x or of -x, whichever is even."""
    xc = fp.canonical(x)
    return torch.where((xc[0] & 1).bool(), fp.canonical(fp.neg(xc)), xc)


def pow_p58(z):
    """z^((p-5)/8) = z^(2^252 - 3): the curve25519 chain (csrc/
    ristretto.cu fe8_pow_p58, ops/curve.inv_fp's first steps)."""
    def sq_n(x, n):
        for _ in range(n):
            x = fp.mul(x, x)
        return x
    z2 = fp.mul(z, z)
    z9 = fp.mul(sq_n(z2, 2), z)
    z11 = fp.mul(z9, z2)
    z_5_0 = fp.mul(fp.mul(z11, z11), z9)
    z_10_0 = fp.mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = fp.mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = fp.mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = fp.mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = fp.mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = fp.mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = fp.mul(sq_n(z_200_0, 50), z_50_0)
    return fp.mul(sq_n(z_250_0, 2), z)


def sqrt_ratio_m1(u, v):
    """RFC 9496 SQRT_RATIO_M1 -> (was_square bool [k], the non-negative
    root as canonical limbs [NL, k])."""
    v3 = fp.mul(fp.mul(v, v), v)
    v7 = fp.mul(fp.mul(v3, v3), v)
    r = fp.mul(fp.mul(u, v3), pow_p58(fp.mul(u, v7)))
    check = fp.mul(v, fp.mul(r, r))
    neg_u = fp.neg(u)
    sqrt_m1 = _const(SQRT_M1, u)
    correct, flipped = _eq(check, u), _eq(check, neg_u)
    flip = flipped | _eq(check, fp.mul(neg_u, sqrt_m1))
    r = torch.where(flip, fp.mul(r, sqrt_m1), r)
    return correct | flipped, _abs(r)


def compress_cols(cols):
    """[4, NL, k] extended points (any carried limbs) -> uint8 [k, 32]
    encodings: the plain version of `ristretto_compress`."""
    x, y, z, t = (fp.canonical(c) for c in cols.to(torch.int64).unbind(0))
    u1 = fp.mul(fp.add(z, y), fp.sub(z, y))
    u2 = fp.mul(x, y)
    _, invsqrt = sqrt_ratio_m1(_const(1, u1), fp.mul(u1, fp.mul(u2, u2)))
    den1, den2 = fp.mul(invsqrt, u1), fp.mul(invsqrt, u2)
    z_inv = fp.mul(fp.mul(den1, den2), t)
    sqrt_m1 = _const(SQRT_M1, x)
    ix, iy = fp.mul(x, sqrt_m1), fp.mul(y, sqrt_m1)
    ench = fp.mul(den1, _const(INVSQRT_A_MINUS_D, x))
    rotate = _is_negative(fp.mul(t, z_inv))
    xf = torch.where(rotate, iy, x)
    yf = torch.where(rotate, ix, y)
    den_inv = torch.where(rotate, ench, den2)
    yf = torch.where(_is_negative(fp.mul(xf, z_inv)), fp.neg(yf), yf)
    return canonical_bytes(_abs(fp.mul(den_inv, fp.sub(z, yf))))


def ristretto_compress(cols):
    """int32 [4, NL, k] extended points -> uint8 [k, 32] RFC 9496
    encodings.

    Replaces the JAX package's jnp compression under jit
    (bulletproof_gadgets_tpu/ops/ristretto_device.py:173 compress_cols),
    which has no Pallas kernel.  Bound on the H100: latency, one chain of
    278 dependent field operations per point (255 squarings) with only
    the k points of one MSM (2 a round in the IPA, 3 for the commitments).
    Design (csrc/ristretto.cu): one thread per point on the radix-2^32
    core (csrc/field32.cuh), its squarings by the dedicated fe8_sqr, the
    chain inlined (no stack), bytes out, so the transcript kernel reads
    them on the card."""
    native.check(cols, "cols", (4, NL, None))
    lib = native.kernels_for(cols)
    if lib is None:
        return compress_cols(cols)
    k = cols.shape[2]
    out = torch.empty((k, 32), dtype=torch.uint8, device=cols.device)
    if k:
        native.launched("ristretto_compress", lib.bpg_ristretto_compress(
            cols.data_ptr(), k, out.data_ptr(), native.stream(cols)))
    return out


# ---------------------------------------------------------------------------
# generator expansion: RistrettoPoint::from_uniform_bytes in bulk

MAP_CHUNK = 1 << 18       # strings per batch of field ops (~20 MB a value)


def _bytes_to_fe(b):
    """uint8 [k, 32] little-endian (top bit clear) -> int64 [NL, k] limbs
    in [0, 2^W) of the value (< 2^255, not reduced mod p)."""
    v = torch.cat([b.to(torch.int64), torch.zeros_like(b[:, :4],
                                                       dtype=torch.int64)], 1)
    out = []
    for i in range(NL):
        off, sh = fp.S[i] >> 3, fp.S[i] & 7
        word = (v[:, off] | (v[:, off + 1] << 8) | (v[:, off + 2] << 16)
                | (v[:, off + 3] << 24))
        out.append((word >> sh) & ((1 << fp.W[i]) - 1))
    return torch.stack(out)


def _elligator(t):
    """core/ristretto.RistrettoPoint._elligator on limbs [NL, k] -> the
    point (X, Y, Z, T) as carried limbs."""
    one = _const(1, t)
    r = fp.mul(_const(SQRT_M1, t), fp.mul(t, t))
    u = fp.mul(fp.add(r, one), _const(ONE_MINUS_D_SQ, t))
    d = _const(D, t)
    v = fp.mul(fp.sub(fp.neg(one), fp.mul(r, d)), fp.add(r, d))
    was_square, s = sqrt_ratio_m1(u, v)
    s = torch.where(was_square, s, fp.neg(_abs(fp.mul(s, t))))
    c = torch.where(was_square, _const(P - 1, t), r)
    n = fp.sub(fp.mul(fp.mul(c, fp.sub(r, one)), _const(D_MINUS_ONE_SQ, t)),
               v)
    w0 = fp.mul(fp.add(s, s), v)
    w1 = fp.mul(n, _const(SQRT_AD_MINUS_ONE, t))
    ss = fp.mul(s, s)
    w2, w3 = fp.sub(one, ss), fp.add(one, ss)
    return tuple(fp.mul_many([w0, w2, w1, w0], [w3, w1, w3, w2]))


def uniform_bytes_to_cols(b):
    """uint8 [k, 64] on a device -> uint8 [4, k, 32]: the canonical bytes
    of X, Y, Z, T of RistrettoPoint.from_uniform_bytes of each row (the
    two halves' elligator points added by ops/curve.padd, which is
    RistrettoPoint.__add__'s formula)."""
    halves = b.view(-1, 2, 32).clone()
    halves[:, :, 31] &= 0x7F
    p1, p2 = (_elligator(_bytes_to_fe(halves[:, j])) for j in (0, 1))
    return torch.stack([canonical_bytes(fp.canonical(c))
                        for c in curve.padd(p1, p2)])


def points_from_uniform_bytes(stream, device, chunk: int = MAP_CHUNK):
    """stream: bytes of k 64-byte strings -> k RistrettoPoints equal, to the
    coordinate, to RistrettoPoint.from_uniform_bytes of each string; the
    field work runs on `device` in batches of `chunk` strings, then one
    readback per batch."""
    raw = np.frombuffer(stream, dtype=np.uint8).reshape(-1, 64)
    out = []
    for lo in range(0, raw.shape[0], chunk):
        cols = uniform_bytes_to_cols(
            torch.from_numpy(raw[lo:lo + chunk].copy()).to(device))
        xs, ys, zs, ts = (
            [int.from_bytes(bytes(row), "little") for row in c]
            for c in cols.cpu().numpy())
        out += [RistrettoPoint(*v) for v in zip(xs, ys, zs, ts)]
    return out


# ---------------------------------------------------------------------------
# the challenge's F_l steps (rows [..., NW] of ops/fl)

# 4-bit windows of l - 2 below its top window (which is 1), high to low
_L2_NIBS = [((L - 2) >> (4 * i)) & 15 for i in range(62, -1, -1)]
assert (L - 2) >> 252 == 1


def _bytes_to_limbs(b):
    """uint8 [..., 32] (little-endian) -> int64 [..., NW] 26-bit limbs of
    the value (< 2^256: not reduced)."""
    b = torch.cat([b.to(torch.int64), torch.zeros_like(b[..., :8],
                                                       dtype=torch.int64)],
                  -1)
    out = []
    for j in range(fl.NW):
        off, r = (fl.B * j) >> 3, (fl.B * j) & 7
        word = (b[..., off] | (b[..., off + 1] << 8) | (b[..., off + 2] << 16)
                | (b[..., off + 3] << 24) | (b[..., off + 4] << 32))
        out.append((word >> r) & fl.MASK)
    return torch.stack(out, -1)


def challenge_limbs(b64):
    """uint8 [..., 64] challenge bytes -> canonical std F_l rows [..., NW]
    of lo + 2^256 hi mod l (lo, hi the 32-byte halves):
    mont_mul(lo, R mod l) + mont_mul(hi, 2^256 R mod l)."""
    parts = _bytes_to_limbs(torch.stack([b64[..., :32], b64[..., 32:]]))
    mults = torch.stack([fl.const(fl.R, parts), fl.const(fl.R << 256, parts)])
    red = fl.mont_mul(parts, mults.view((2,) + (1,) * (parts.dim() - 2)
                                        + (fl.NW,)))
    return fl.add(red[0], red[1])


def to_mont_dev(x_std):
    """std rows -> Montgomery rows (x R mod l)."""
    return fl.to_mont(x_std)


def inv_mont(x_std):
    """std rows [..., NW] -> Montgomery rows of x^(l-2) = 1/x: a table of
    x^0 .. x^15, then per 4-bit window of l - 2 four squarings and, for a
    window that is not zero, one product.  The plain version of the
    transcript kernel's inversion (csrc/field_l.cuh fl8_inv_mont: divsteps,
    another algorithm to the same canonical value)."""
    x_m = fl.to_mont(x_std)
    tab = [fl.const(fl.R, x_m).expand_as(x_m), x_m]
    for _ in range(14):
        tab.append(fl.mont_mul(tab[-1], x_m))
    acc = x_m
    for nib in _L2_NIBS:
        for _ in range(4):
            acc = fl.mont_mul(acc, acc)
        if nib:
            acc = fl.mont_mul(acc, tab[nib])
    return acc
