"""F_p arithmetic (p = 2^255 - 19) on torch tensors: the plain version of the
field code that every CUDA kernel includes (csrc/field.cuh).

Layout (chosen for Hopper, not carried over from the TPU): a field element
is NL = 10 signed limbs on the LEADING axis, radix 2^25.5 as in ref10.  Limb
i weighs 2^S[i] and is W[i] = 26, 25, 26, ... bits wide, so the value is
sum_i limb[i] * 2^S[i].  The TPU layout (20 x 13-bit int32, ops/fp.py of the
JAX package) was forced by a vector unit without a 64-bit multiply; the
H100 multiplies 32 x 32 -> 64 bits natively, so half the limbs and a
quarter of the partial products.

Two kinds of values:
  * carried: the output of `mul` (and canonical table limbs).  The rounding
    carry leaves every limb in [-2^(W-1), 2^(W-1)] plus a carry of a few
    bits on limbs 1 and 5 (see CARRY_ORDER); canonical limbs are [0, 2^W).
  * lazy: a sum or difference of at most a few carried values (`add`,
    `sub` do no carry).  Only `mul` consumes lazy values.
`mul` forms 10 column sums of int64 products (2x for odd*odd limb pairs,
19x for columns that wrap past 2^255), then one rounding-carry chain.
tests/test_torch_bounds.py proves by interval arithmetic over the exact op
sequences of ops/curve.py that no int64 (products, column sums) or int32
(stored limbs, in the kernels) value overflows, and that the carried bound
sustains itself.  Right shifts of negative int64 values are arithmetic
(floor) both in torch and in nvcc; the carries rely on that.

Tensors here are int64; the kernels store the same limbs as int32 and
compute the same integers, so plain and kernel results agree limb for limb.
The bucket accumulation (K1, K2, K8-K10) adds in radix 2^32 instead
(csrc/field32.cuh) and shares only values with this module: it writes
canonical limbs, and its plain versions apply `canonical` to match.
"""
import functools

import numpy as np
import torch

NL = 10
W = (26, 25) * 5                                  # limb widths
S = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)  # limb shifts: ceil(25.5 i)
P = (1 << 255) - 19
# ref10's interleaved carry order: two independent chains, then the wrap
# (carry out of limb 9 weighs 2^255 = 19 mod p) and one more carry of limb 0
CARRY_ORDER = (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0)


def _mul_tables():
    """J[i, k] = the limb of g that meets limb i of f in column k, and
    F[i, k] = that product's factor: 2 for odd*odd limb pairs (their shifts
    sum to S[i+j] + 1), 19 for pairs whose shifts wrap past 2^255."""
    j = np.empty((NL, NL), dtype=np.int64)
    f = np.empty((NL, NL), dtype=np.int64)
    for i in range(NL):
        for k in range(NL):
            jj = (k - i) % NL
            j[i, k] = jj
            f[i, k] = ((2 if (i & 1) and (jj & 1) else 1)
                       * (19 if i + jj >= NL else 1))
    return torch.from_numpy(j), torch.from_numpy(f)


_J, _F = _mul_tables()


@functools.lru_cache(maxsize=None)
def _tables(device):
    return _J.to(device), _F.to(device)


def int_to_limbs(v: int) -> list:
    """Canonical limbs of v mod p (Python ints)."""
    v %= P
    return [(v >> S[i]) & ((1 << W[i]) - 1) for i in range(NL)]


D2 = int_to_limbs(2 * (-121665 * pow(121666, P - 2, P)) % P)   # 2d mod p
# 8p split so every limb is >= 2^28 - 152: adding it makes any lazy value
# (|limb| < 2^28 - 152) limb-wise non-negative without changing it mod p
_BIAS_8P = [8 * ((1 << W[i]) - (19 if i == 0 else 1)) for i in range(NL)]
assert sum(b << s for b, s in zip(_BIAS_8P, S)) == 8 * P


def const(limbs, like):
    """Limb constant shaped to broadcast against `like` ([NL, ...])."""
    return _const(tuple(limbs), like.device, like.dim())


@functools.lru_cache(maxsize=None)
def _const(limbs, device, dim):
    return torch.tensor(limbs, dtype=torch.int64, device=device).view(
        (NL,) + (1,) * (dim - 1))


def d2_like(x):
    return const(D2, x)


# -- arithmetic ---------------------------------------------------------------

def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def carry(h):
    """Rounding carry chain in CARRY_ORDER on int64 columns [NL, ...].  The
    two chains (limbs 0..4 and 4..9) run as strided pairs (i, i+4), which
    is the same arithmetic as the sequential order."""
    h = h.clone()
    for i in (0, 1, 2, 3, 4):                 # pairs (i, i+4), width W[i]
        lo = h[i:i + 5:4]
        c = (lo + (1 << (W[i] - 1))) >> W[i]
        lo -= c * (1 << W[i])
        h[i + 1:i + 6:4] += c
    c = (h[9] + (1 << 24)) >> 25              # 2^255 = 19 mod p
    h[9] -= c * (1 << 25)
    h[0] += 19 * c
    c = (h[0] + (1 << 25)) >> 26
    h[0] -= c * (1 << 26)
    h[1] += c
    return h


def mul(f, g):
    """f * g mod p; f, g int64 [NL, ...] (carried or lazy).  Narrow operands
    form all NL x NL products at once; wide ones accumulate the column
    sums limb row by limb row (no [NL, NL, ...] temporary: ~2x faster on
    the CPU past a few thousand lanes)."""
    j, fac = _tables(f.device)
    fac = fac.view((NL, NL) + (1,) * (f.dim() - 1))
    if f[0].numel() < 4096:
        return carry((f.unsqueeze(1) * g[j] * fac).sum(0))
    cols = f[0] * g[j[0]] * fac[0]
    for i in range(1, NL):
        cols += f[i] * g[j[i]] * fac[i]
    return carry(cols)


def mul_many(fs, gs):
    """[f * g for f, g in zip(fs, gs)] as one stacked `mul`."""
    r = mul(torch.stack(fs, 1), torch.stack(gs, 1))
    return list(r.unbind(1))


def canonical(h):
    """The unique limbs in [0, 2^W[i]) of the value mod p (|limb| < 2^28)."""
    h = list((h + const(_BIAS_8P, h)).unbind(0))
    for _ in range(3):                      # floor carries, wrap 2^255 = 19
        for i in range(NL):
            c = h[i] >> W[i]
            h[i] = h[i] & ((1 << W[i]) - 1)
            if i == NL - 1:
                h[0] = h[0] + 19 * c
            else:
                h[i + 1] = h[i + 1] + c
    # now 0 <= value < 2^255; subtract p once iff value + 19 >= 2^255
    q = (h[0] + 19) >> W[0]
    for i in range(1, NL):
        q = (h[i] + q) >> W[i]
    h[0] = h[0] + 19 * q
    for i in range(NL):
        c = h[i] >> W[i]
        h[i] = h[i] & ((1 << W[i]) - 1)
        if i < NL - 1:
            h[i + 1] = h[i + 1] + c
    return torch.stack(h)


# -- host conversions ---------------------------------------------------------

def ints_to_limbs(values) -> np.ndarray:
    """Python ints -> canonical limbs [NL, n] int32 (values reduced mod p
    first), vectorised over the little-endian bytes."""
    n = len(values)
    raw = b"".join((v % P).to_bytes(32, "little") for v in values)
    u8 = np.frombuffer(raw, dtype=np.uint8).reshape(n, 32).astype(np.int64)
    out = np.empty((NL, n), dtype=np.int32)
    for i in range(NL):
        off, sh = S[i] >> 3, S[i] & 7       # sh + W[i] <= 32 for every limb
        word = (u8[:, off] | (u8[:, off + 1] << 8) | (u8[:, off + 2] << 16)
                | (u8[:, off + 3] << 24))
        out[i] = (word >> sh) & ((1 << W[i]) - 1)
    return out


def limbs_to_ints(arr) -> list:
    """Limbs [NL, n] (any signs) -> canonical Python ints."""
    a = np.asarray(arr).reshape(NL, -1).astype(np.int64)
    cols = [[int(x) for x in a[i]] for i in range(NL)]
    return [sum(cols[i][j] << S[i] for i in range(NL)) % P
            for j in range(a.shape[1])]


# -- the JAX package's 13-bit layout (tests and carried-over tables) -----------

_B13, _NL13 = 13, 20


def _bits_lsb_first(v: np.ndarray, width: int) -> np.ndarray:
    """[n, k] non-negative ints -> [n, k*width] bits, lsb first per entry."""
    return ((v[:, :, None] >> np.arange(width)) & 1).reshape(v.shape[0], -1)


def limbs13_to_limbs(cols13) -> np.ndarray:
    """[20, n] 13-bit limb columns (non-negative, lazily reduced as the JAX
    package leaves them) -> canonical port limbs [NL, n] int32."""
    c = np.asarray(cols13).astype(np.int64).T.copy()          # [n, 20]
    for _ in range(3):      # carry to 13-bit limbs; 2^260 = 608 mod p
        for j in range(_NL13):
            carry_ = c[:, j] >> _B13
            c[:, j] &= (1 << _B13) - 1
            if j < _NL13 - 1:
                c[:, j + 1] += carry_
            else:
                c[:, 0] += 608 * carry_
    bits = _bits_lsb_first(c, _B13)                          # [n, 260]
    out = np.zeros((NL, c.shape[0]), dtype=np.int64)
    for i in range(NL):
        out[i] = bits[:, S[i]:S[i] + W[i]] @ (1 << np.arange(W[i]))
    out[0] += 19 * (bits[:, 255:260] @ (1 << np.arange(5)))   # 2^255 = 19
    return canonical(torch.from_numpy(out)).numpy().astype(np.int32)


def limbs_to_limbs13(limbs) -> np.ndarray:
    """Port limbs [NL, n] -> canonical 13-bit limb columns [20, n] int32."""
    can = canonical(torch.as_tensor(np.asarray(limbs), dtype=torch.int64))
    can = can.numpy().T                                        # [n, NL]
    bits = np.zeros((can.shape[0], _B13 * _NL13), dtype=np.int64)
    for i in range(NL):
        bits[:, S[i]:S[i] + W[i]] = _bits_lsb_first(can[:, i:i + 1], W[i])
    groups = bits.reshape(-1, _NL13, _B13)
    return (groups @ (1 << np.arange(_B13))).T.astype(np.int32)
