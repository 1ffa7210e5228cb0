"""F_l arithmetic (l = the Ristretto255 group order) on int64 torch tensors:
the port of the JAX package's ops/fl.py, plain PyTorch, run on the card by
the device inner-product argument (ops/ipa_device, ops/ipa_fused) and on the
CPU by the tests.

Layout (the port's choice, not the TPU's): an element is NW = 10 limbs of
B = 26 bits on the LAST axis (rows [n, NW], as in the JAX package), int64,
value = sum_j limb[j] * 2^(26 j).  Every function here returns CANONICAL
elements: limbs in [0, 2^26) and value < l, so equal values have equal
limbs.  Montgomery form uses R = 2^260 (the JAX package uses 2^273); only
standard-form values are compared between the two packages.

`mont_mul` is word-serial Montgomery reduction (CIOS) over the limbs.  Each
of its NW steps adds a_i * b and m_i * l (products below 2^52) to an int64
accumulator; a column takes at most 2 * NW such terms plus a carry, so it
stays below 2^58.  One exact carry pass and one conditional subtraction of
l end it.  One operand may be any normalized value below 2^260, the other
must be canonical: then (a * b + M * l) / R < l + l.
"""
import functools

import numpy as np
import torch

from ..core.scalar import L
from ..utils import profiling

B = 26
NW = 10
MASK = (1 << B) - 1
R = 1 << (B * NW)                 # 2^260
R2 = R * R % L
N_PRIME = (-pow(L, -1, 1 << B)) % (1 << B)   # -l^-1 mod 2^26
_L_LIMBS = tuple((L >> (B * j)) & MASK for j in range(NW))
_BYTES = 40                       # 2^260 needs 33 bytes; room for 5-byte words


@functools.lru_cache(maxsize=None)
def _col(limbs, device):
    """Limb constant as a limb-leading column [NW, 1]."""
    return torch.tensor(limbs, dtype=torch.int64, device=device)[:, None]


def const(value: int, like) -> torch.Tensor:
    """The canonical limbs of `value` as a [NW] row on like's device."""
    return _col(tuple((value % L >> (B * j)) & MASK for j in range(NW)),
                like.device)[:, 0]


# -- limb-leading internals ([NW, n]) -----------------------------------------

def carry(t):
    """Exact carry pass in place over the leading (limb) axis; limbs may be
    negative (floor shifts).  The last limb keeps what is left."""
    for j in range(t.shape[0] - 1):
        c = t[j] >> B
        t[j] &= MASK
        t[j + 1] += c
    return t


def _reduce_once(r):
    """r: normalized [NW, n] with value < 2l -> value mod l (canonical)."""
    d = carry(r - _col(_L_LIMBS, r.device))
    return torch.where(d[NW - 1] < 0, r, d)


def _flat(x):
    """[..., NW] -> limb-leading [NW, n] (and the batch shape)."""
    return x.reshape(-1, NW).t(), x.shape[:-1]


def _unflat(t, shape):
    return t.t().reshape(tuple(shape) + (NW,))


# -- arithmetic on rows [..., NW] ---------------------------------------------

def mont_mul(a, b):
    """a * b / R mod l, canonical.  a, b broadcast over the leading axes;
    one of them normalized below 2^260, the other canonical."""
    a, b = torch.broadcast_tensors(a, b)
    x, shape = _flat(a)
    y, _ = _flat(b)
    ll = _col(_L_LIMBS, x.device)
    t = torch.zeros((2 * NW, x.shape[1]), dtype=torch.int64, device=x.device)
    for i in range(NW):
        t[i:i + NW] += x[i] * y
        m = ((t[i] & MASK) * N_PRIME) & MASK
        t[i:i + NW] += m * ll
        t[i + 1] += t[i] >> B              # t[i] is now 0 mod 2^26
    return _unflat(_reduce_once(carry(t[NW:].clone())), shape)


def add(a, b):
    """(a + b) mod l, canonical; a, b canonical."""
    a, b = torch.broadcast_tensors(a, b)
    x, shape = _flat(a + b)
    return _unflat(_reduce_once(carry(x.clone())), shape)


def to_mont(x):
    """Rows below 2^260 -> canonical Montgomery rows (x * R mod l)."""
    return mont_mul(x, const(R2, x))


def from_mont(x):
    """Montgomery rows -> canonical std rows (x / R mod l)."""
    return mont_mul(x, const(1, x))


# -- host conversions ---------------------------------------------------------

def to_limbs(values, device="cpu") -> torch.Tensor:
    """Python ints in [0, 2^260) -> limb rows [n, NW] int64 (no reduction:
    callers pass canonical values unless a test wants otherwise)."""
    n = len(values)
    raw = b"".join(v.to_bytes(_BYTES, "little") for v in values)
    u8 = np.frombuffer(raw, dtype=np.uint8).reshape(n, _BYTES).astype(
        np.int64)
    out = np.empty((n, NW), dtype=np.int64)
    for j in range(NW):
        off, sh = (B * j) >> 3, (B * j) & 7   # sh + 26 <= 33 bits: 5 bytes
        word = sum(u8[:, off + q] << (8 * q) for q in range(5))
        out[:, j] = (word >> sh) & MASK
    return torch.from_numpy(out).to(device)


def limbs_to_ints(arr) -> list:
    """Rows [..., NW] (any limb signs) -> canonical ints mod l (a device
    tensor is read back through profiling.readback)."""
    a = np.asarray(profiling.readback(arr) if isinstance(arr, torch.Tensor)
                   else arr)
    a = a.reshape(-1, NW).astype(object)
    return [sum(int(row[j]) << (B * j) for j in range(NW)) % L for row in a]


def from_rows13(rows13, mont: bool = False) -> torch.Tensor:
    """The JAX package's F_l rows ([n, 21] limbs of 13 bits, lazily
    reduced; Montgomery R = 2^273 when `mont`) -> this package's canonical
    rows [n, NW] (in its own Montgomery form when `mont`)."""
    a = np.asarray(rows13).reshape(-1, 21).astype(object)
    vals = [sum(int(row[j]) << (13 * j) for j in range(21)) % L for row in a]
    if mont:
        conv = pow(1 << 273, -1, L) * R % L
        vals = [v * conv % L for v in vals]
    return to_limbs(vals)
