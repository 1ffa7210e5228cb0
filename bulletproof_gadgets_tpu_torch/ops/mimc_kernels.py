"""Batched MiMCHash-256b sponge on the device: the port of the JAX package's
ops/mimc_kernels.py (plain array code there too: no Pallas kernel).

Same semantics as the host models/mimc.py (486 rounds of x^3 + round
constant, zero keys, sponge over 32-byte blocks), vectorized over a batch
of preimages as Montgomery F_l rows (ops/fl).  Batched proving
(lang/batch.warm_image_cache) hashes every witness and instance value of a
batch here once and seeds models.mimc's image cache.
"""
import functools

import torch

from . import fl, flvec
from ..core.scalar import L, Scalar
from ..models import mimc as mimc_host
from ..models.mimc_constants import ROUND_CONSTANTS
from ..utils.conversions import be_to_scalars

NUM_ROUNDS = 486


@functools.lru_cache(maxsize=4)
def _consts_mont(device) -> torch.Tensor:
    """The round constants as Montgomery rows [NUM_ROUNDS, NW]."""
    return flvec.to_mont([c % L for c in ROUND_CONSTANTS], device)


def mimc_sponge_device(blocks_mont):
    """blocks_mont: [batch, n_blocks, NW] Montgomery rows -> [batch, NW]
    Montgomery rows of the final sponge state."""
    consts = _consts_mont(blocks_mont.device)
    state = torch.zeros_like(blocks_mont[:, 0])
    for j in range(blocks_mont.shape[1]):
        state = fl.add(state, blocks_mont[:, j])
        for i in range(NUM_ROUNDS):
            x = fl.add(state, consts[i])
            state = fl.mont_mul(fl.mont_mul(x, x), x)
    return state


def mimc_hash_batch(preimages, device) -> list:
    """Hash a batch of byte-string preimages on `device` (bit-exact against
    the host mimc_hash) -> list of Scalars.  Preimages are grouped by
    padded block count, one sponge call per group."""
    results = [None] * len(preimages)
    groups = {}
    for idx, data in enumerate(preimages):
        scalars = mimc_host.pad_preimage(be_to_scalars(data))
        groups.setdefault(len(scalars), []).append((idx, scalars))
    for n_blocks, entries in groups.items():
        blocks = flvec.to_mont([s.v for _, scalars in entries
                                for s in scalars], device)
        out = fl.from_mont(mimc_sponge_device(
            blocks.view(len(entries), n_blocks, fl.NW)))
        for (idx, _), v in zip(entries, fl.limbs_to_ints(out)):
            results[idx] = Scalar(v)
    return results
