"""Constraint flattening on the device (dalek's `flattened_constraints`): the
port of the JAX package's ops/flatten.py.

For the challenge z, constraint q contributes z^(q+1) * coeff to the weight
of each of its terms' variables (wL, wR, wO; wV and the verifier's constant
wc negated).  Here:

  * z-powers z^1..z^Q: ops/flvec.powers_mont (log2 Q doubling mont_muls);
  * per term z^(q+1) * coeff as one gathered mont_mul over [T, NW] rows
    (coefficients deduplicated into a pool: circuits reuse a few constants,
    +-1, bit weights 2^i, the MiMC round constants);
  * the per-variable sums as one `index_add_` of the int64 limb rows, then
    one carry and reduction (ops/flvec.reduce_sums).  With 26-bit limbs an
    int64 column holds 2^37 terms, so the JAX package's _SCATTER_CHUNK
    splitting (int32 columns) is not needed.

The only per-term Python work is the extraction of the index arrays and the
coefficient pool, cached by the constraint list (`_extract_cache`: the
circuit template cache shares one constraint list across proves of a
statement, so a warm prove or verify skips it).

Below MIN_DEVICE_TERMS terms the host loop (core/r1cs
`_flattened_constraints`) is used: a size rule decided before any device
work, as the JAX package decides it.  Not ported: the JAX package's slab
path past MAX_DEVICE_TERMS = 2^21 terms, which works around a remote XLA
compile running out of memory (ROADMAP "Not ported").
"""
import numpy as np
import torch

from . import fl, flvec
from ..core.lc import ONE, COMMITTED, MULT_LEFT, MULT_RIGHT, MULT_OUT
from ..core.scalar import L

MIN_DEVICE_TERMS = 2048   # below this many terms the host loop is used


class Flattened:
    """wL/wR/wO as device [n, NW] canonical std rows; wV (and wc for the
    verifier) as canonical host ints."""

    __slots__ = ("wL", "wR", "wO", "wV", "wc")

    def __init__(self, wL, wR, wO, wV, wc):
        self.wL, self.wR, self.wO, self.wV, self.wc = wL, wR, wO, wV, wc

    def ints(self):
        """Canonical host ints (wL, wR, wO), for oracle tests."""
        n = self.wL.shape[0]
        vals = fl.limbs_to_ints(torch.cat([self.wL, self.wR, self.wO]))
        return vals[:n], vals[n:2 * n], vals[2 * n:]


# (id(constraints), count, terms, n, m, device) -> (constraints, cidx, uidx,
# tgt, coeff rows, n_targets).  Each entry pins its list, so the id cannot
# be reused by another list while the entry lives.
_extract_cache = {}
_EXTRACT_CACHE_CAP = 16


def _extract(constraints, total_terms, n, m, device):
    """Index arrays of every term: its constraint q, its coefficient's slot
    in the pool, its target row ([0,n) aL | [n,2n) aR | [2n,3n) aO |
    [3n,3n+m) V | 3n+m One), and the pool as std rows on the device."""
    base = {MULT_LEFT: 0, MULT_RIGHT: n, MULT_OUT: 2 * n, COMMITTED: 3 * n,
            ONE: 3 * n + m}
    pool, pool_vals = {}, []
    cidx = np.empty(total_terms, dtype=np.int64)
    uidx = np.empty(total_terms, dtype=np.int64)
    tgt = np.empty(total_terms, dtype=np.int64)
    t = 0
    for q, lc in enumerate(constraints):
        for var, coeff in lc.terms:
            kind = var.kind
            # COMMITTED and One() accumulate negated (dalek's convention)
            c = coeff.v % L if kind in (MULT_LEFT, MULT_RIGHT, MULT_OUT) \
                else -coeff.v % L
            u = pool.get(c)
            if u is None:
                u = pool[c] = len(pool_vals)
                pool_vals.append(c)
            cidx[t] = q
            uidx[t] = u
            tgt[t] = base[kind] + (var.index if kind != ONE else 0)
            t += 1
    assert t == total_terms
    up = lambda a: torch.from_numpy(a).to(device)           # noqa: E731
    return (constraints, up(cidx), up(uidx), up(tgt),
            fl.to_limbs(pool_vals, device), 3 * n + m + 1)


def flatten(constraints, n: int, m: int, z: int, with_wc: bool, device,
            min_device_terms: int = None):
    """constraints: list[LinearCombination]; n multipliers, m commitments.

    Returns Flattened: device wL/wR/wO, host wV (length m, negated like
    dalek's) and wc (the verifier's constant, negated; None unless
    with_wc).  Returns None below `min_device_terms` (default
    MIN_DEVICE_TERMS) terms or for n = 0: the caller runs the host loop."""
    if min_device_terms is None:
        min_device_terms = MIN_DEVICE_TERMS
    total_terms = sum(len(lc.terms) for lc in constraints)
    if total_terms < min_device_terms or n == 0 or total_terms == 0:
        return None
    device = torch.device(device)
    key = (id(constraints), len(constraints), total_terms, n, m, str(device))
    hit = _extract_cache.pop(key, None)
    if hit is None or hit[0] is not constraints:
        hit = _extract(constraints, total_terms, n, m, device)
    _extract_cache[key] = hit                    # insert or LRU refresh
    while len(_extract_cache) > _EXTRACT_CACHE_CAP:
        _extract_cache.pop(next(iter(_extract_cache)))
    _, cidx, uidx, tgt, coeff, n_targets = hit

    zpow = flvec.powers_mont(z, len(constraints) + 1, device)[1:]
    w = fl.mont_mul(zpow[cidx], coeff[uidx])        # [T, NW] std, canonical
    acc = torch.zeros((n_targets, fl.NW), dtype=torch.int64, device=device)
    acc.index_add_(0, tgt, w)
    sums = flvec.reduce_sums(acc)
    host = fl.limbs_to_ints(sums[3 * n:])           # wV and wc: one readback
    return Flattened(sums[:n], sums[n:2 * n], sums[2 * n:3 * n], host[:m],
                     host[m] if with_wc else None)
