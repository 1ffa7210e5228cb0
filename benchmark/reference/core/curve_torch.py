"""Curve25519 field and Ristretto point arithmetic in plain PyTorch: the
reference verifier's generators and its one large multiscalar check, on
whatever device the tensors live on.

A field element is an int64 tensor [..., 16] of 16-bit limbs, value
sum(limb_i * 2^(16 i)) mod p, not reduced.  `mul` takes limbs below 2^21
and returns limbs below 2^17; `sub(a, b)` needs b's limbs below 2^18 (it
adds BIAS, a multiple of p whose limbs are all at least 2^18).  Each point
formula below keeps its products' inputs inside those limits.  `canon`
gives the exact residue in [0, p), limbs below 2^16.
"""
import hashlib

import numpy as np
import torch

from .ristretto import (P, D, SQRT_M1, SQRT_AD_MINUS_ONE, ONE_MINUS_D_SQ,
                        D_MINUS_ONE_SQ)

NL = 16
MASK = 0xFFFF


def _limbs(v: int):
    v %= P
    return [(v >> (16 * i)) & MASK for i in range(NL)]


def _bias():
    m = sum((1 << 18) << (16 * i) for i in range(NL))
    d = (-m) % P
    return [(1 << 18) + ((d >> (16 * i)) & MASK) for i in range(NL)]


class Consts:
    """The constants as limb tensors on one device."""

    def __init__(self, device):
        def c(limbs):
            return torch.tensor(limbs, dtype=torch.int64, device=device)
        self.device = device
        self.bias = c(_bias())
        self.one = c(_limbs(1))
        self.minus_one = c(_limbs(P - 1))
        self.d = c(_limbs(D))
        self.d2 = c(_limbs(2 * D))
        self.sqrt_m1 = c(_limbs(SQRT_M1))
        self.sqrt_ad_minus_one = c(_limbs(SQRT_AD_MINUS_ONE))
        self.one_minus_d_sq = c(_limbs(ONE_MINUS_D_SQ))
        self.d_minus_one_sq = c(_limbs(D_MINUS_ONE_SQ))
        self.p19 = 19


def to_limbs(values, device) -> torch.Tensor:
    """ints -> int64 [N, 16] on device."""
    raw = b"".join((v % P).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<u2").reshape(-1, NL).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def to_ints(t: torch.Tensor):
    """int64 [N, 16] (any non-negative limbs) -> ints mod p."""
    arr = t.cpu().numpy()
    return [sum(int(x) << (16 * i) for i, x in enumerate(row)) % P
            for row in arr]


def _carry(x, rounds):
    for _ in range(rounds):
        c = x >> 16
        x = (x & MASK) + torch.cat([38 * c[..., 15:], c[..., :15]], dim=-1)
    return x


def mul(a, b):
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)                # [..., 16, 16]
    lead = prod.shape[:-2]
    # skew row i right by i, then sum the rows: column k = sum_{i+j=k}
    padded = torch.cat([prod, torch.zeros_like(prod)], dim=-1)
    cols = padded.reshape(*lead, 32 * NL)[..., :31 * NL].reshape(
        *lead, NL, 31).sum(-2)                              # [..., 31]
    lo = cols[..., :NL] + 38 * torch.cat(
        [cols[..., NL:], torch.zeros_like(cols[..., :1])], dim=-1)
    return _carry(lo, 4)


def sq(a):
    return mul(a, a)


def sqn(a, n):
    for _ in range(n):
        a = mul(a, a)
    return a


def sub(k, a, b):
    return a + k.bias - b


def canon(x):
    """Exact residue in [0, p), limbs below 2^16."""
    col = list(_carry(x, 4).unbind(-1))
    for _ in range(3):
        for i in range(NL):
            c = col[i] >> 16
            col[i] = col[i] & MASK
            if i < NL - 1:
                col[i + 1] = col[i + 1] + c
            else:
                col[0] = col[0] + 38 * c
    # value < 2^256: fold bit 255, then subtract p once where v >= p
    q = col[15] >> 15
    col[15] = col[15] & 0x7FFF
    col[0] = col[0] + 19 * q
    for i in range(NL - 1):
        c = col[i] >> 16
        col[i] = col[i] & MASK
        col[i + 1] = col[i + 1] + c
    t = list(col)
    t[0] = t[0] + 19
    for i in range(NL - 1):
        c = t[i] >> 16
        t[i] = t[i] & MASK
        t[i + 1] = t[i + 1] + c
    ge = (t[15] >> 15) == 1
    t[15] = t[15] & 0x7FFF
    return torch.where(ge.unsqueeze(-1), torch.stack(t, -1),
                       torch.stack(col, -1))


def is_negative(x):
    return (canon(x)[..., 0] & 1) == 1


def equal(a, b):
    return (canon(a) == canon(b)).all(-1)


def ct_abs(k, x):
    xc = canon(x)
    return torch.where(((xc[..., 0] & 1) == 1).unsqueeze(-1),
                       canon(sub(k, torch.zeros_like(xc), xc)), xc)


def pow_p58(z):
    """z^((p - 5) / 8) = z^(2^252 - 3) (the ref10 addition chain)."""
    z2 = sq(z)
    z9 = mul(sqn(z2, 2), z)
    z11 = mul(z9, z2)
    t = mul(sq(z11), z9)                 # 2^5 - 1
    t = mul(sqn(t, 5), t)                # 2^10 - 1
    t10 = t
    t = mul(sqn(t, 10), t)               # 2^20 - 1
    t = mul(sqn(t, 20), t)               # 2^40 - 1
    t = mul(sqn(t, 10), t10)             # 2^50 - 1
    t50 = t
    t = mul(sqn(t, 50), t)               # 2^100 - 1
    t = mul(sqn(t, 100), t)              # 2^200 - 1
    t = mul(sqn(t, 50), t50)             # 2^250 - 1
    return mul(sqn(t, 2), z)             # 2^252 - 3


def sqrt_ratio_m1(k, u, v):
    """(was_square, non-negative sqrt(u/v)) per RFC 9496; u, v products."""
    v3 = mul(sq(v), v)
    v7 = mul(sq(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7)))
    check = mul(v, sq(r))
    neg_u = sub(k, torch.zeros_like(u), u)
    correct = equal(check, u)
    flipped = equal(check, neg_u)
    flipped_i = equal(check, mul(neg_u, k.sqrt_m1))
    r = torch.where((flipped | flipped_i).unsqueeze(-1), mul(r, k.sqrt_m1), r)
    return correct | flipped, ct_abs(k, r)


def elligator(k, t):
    """RFC 9496 MAP of field elements t [N, 16] -> extended points."""
    r = mul(k.sqrt_m1, sq(t))
    u = mul(r + k.one, k.one_minus_d_sq)
    v = mul(sub(k, k.minus_one, mul(r, k.d)), r + k.d)
    was_square, s = sqrt_ratio_m1(k, u, v)
    s_alt = sub(k, torch.zeros_like(s), ct_abs(k, mul(s, t)))
    ws = was_square.unsqueeze(-1)
    s = torch.where(ws, s, canon(s_alt))
    c = torch.where(ws, k.minus_one.expand_as(r), r)
    n = sub(k, mul(mul(c, sub(k, r, k.one)), k.d_minus_one_sq), v)
    ss = sq(s)
    w0 = mul(s + s, v)
    w1 = mul(n, k.sqrt_ad_minus_one)
    w2 = sub(k, k.one.expand_as(ss), ss)
    w3 = ss + k.one
    return (mul(w0, w3), mul(w2, w1), mul(w1, w3), mul(w0, w2))


def add(k, p1, p2):
    """Unified extended addition (a = -1), Hisil et al."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = mul(sub(k, Y1, X1), sub(k, Y2, X2))
    B = mul(Y1 + X1, Y2 + X2)
    C = mul(mul(T1, k.d2), T2)
    Dv = 2 * mul(Z1, Z2)
    E, F, G, H = sub(k, B, A), sub(k, Dv, C), Dv + C, B + A
    return (mul(E, F), mul(G, H), mul(F, G), mul(E, H))


def double(k, p):
    X, Y, Z, _ = p
    A = sq(X)
    B = sq(Y)
    C = 2 * sq(Z)
    H = A + B
    E = sub(k, H, sq(X + Y))
    G = sub(k, A, B)
    F = C + G
    return (mul(E, F), mul(G, H), mul(F, G), mul(E, H))


def identity(k, n):
    zero = torch.zeros((n, NL), dtype=torch.int64, device=k.device)
    one = k.one.expand(n, NL).contiguous()
    return (zero, one, one.clone(), zero.clone())


def from_uniform_bytes(k, blocks: bytes):
    """64-byte blocks -> RistrettoPoint::from_uniform_bytes of each, as
    extended points [N, 16] x 4."""
    arr = np.frombuffer(blocks, dtype="<u2").reshape(-1, 2, NL)
    arr = arr.astype(np.int64)
    arr[:, :, 15] &= 0x7FFF
    t = torch.from_numpy(arr).to(k.device)
    n = t.shape[0]
    both = elligator(k, torch.cat([t[:, 0], t[:, 1]]))
    return add(k, tuple(c[:n] for c in both), tuple(c[n:] for c in both))


def generators(k, n: int):
    """dalek BulletproofGens(n, 1): the G and H chains (SHAKE256 of
    b"GeneratorsChain" || label, 64-byte blocks) -> two point tensors."""
    out = []
    for label in (b"G", b"H"):
        stream = hashlib.shake_256(
            b"GeneratorsChain" + label + (0).to_bytes(4, "little")
        ).digest(64 * n)
        out.append(from_uniform_bytes(k, stream))
    return out


def cat_points(parts):
    return tuple(torch.cat([p[c] for p in parts]) for c in range(4))


def scalar_digits(scalars, device) -> torch.Tensor:
    """ints in [0, 2^256) -> int64 [N, 64], little-endian 4-bit digits."""
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    byte = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 32)
    digits = np.stack([byte & 15, byte >> 4], axis=2).reshape(-1, 64)
    return torch.from_numpy(digits.astype(np.int64)).to(device)


def _select(table, digit):
    """table: 4 tensors [16, N, 16]; digit int64 [N] -> the point rows."""
    idx = digit.view(1, -1, 1).expand(1, -1, NL)
    return tuple(c.gather(0, idx).squeeze(0) for c in table)


def msm(k, scalars, points, nwin=64, chunk=1 << 16):
    """sum scalars[i] * points[i] -> extended point as ints (X, Y, Z, T).
    Fixed 4-bit windows over all points at once (a table of 16 multiples
    of each point, then 4 doublings and one addition a window), in chunks
    of `chunk` points, then a tree of additions."""
    n = len(scalars)
    partial = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        digits = scalar_digits(scalars[lo:hi], k.device)
        pts = tuple(c[lo:hi] for c in points)
        mults = [identity(k, hi - lo), pts]
        for _ in range(14):
            mults.append(add(k, mults[-1], pts))
        table = tuple(torch.stack([m[c] for m in mults]) for c in range(4))
        del mults
        acc = _select(table, digits[:, nwin - 1])
        for w in range(nwin - 2, -1, -1):
            for _ in range(4):
                acc = double(k, acc)
            acc = add(k, acc, _select(table, digits[:, w]))
        partial.append(acc)
    acc = cat_points(partial)
    while acc[0].shape[0] > 1:
        m = acc[0].shape[0]
        if m % 2:
            acc = cat_points([acc, identity(k, 1)])
            m += 1
        acc = add(k, tuple(c[:m // 2] for c in acc),
                  tuple(c[m // 2:] for c in acc))
    return tuple(to_ints(c)[0] for c in acc)
