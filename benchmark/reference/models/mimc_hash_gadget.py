"""HASH gadget: in-circuit MiMCHash-256b
(reference src/mimc_hash/mimc_hash_gadget.rs).

486 rounds x 2 multiplications per 32-byte block (square then cube), plus
padding-honesty constraint.  One <=32-byte preimage block is ~1946
constraints (or_conjunction.rs:85)."""

from ..core.scalar import Scalar
from ..core.lc import to_lc
from ..utils.conversions import (le_to_scalar, remove_zero_padding,
                                 pkcs7_pad)
from .gadget import Gadget
from .mimc_constants import ROUND_CONSTANTS

ROUNDS = 486
BLOCK_SIZE = 32

_ROUND_CONSTANT_SCALARS = None


def round_constant_scalars():
    global _ROUND_CONSTANT_SCALARS
    if _ROUND_CONSTANT_SCALARS is None:
        _ROUND_CONSTANT_SCALARS = tuple(Scalar(c) for c in ROUND_CONSTANTS)
    return _ROUND_CONSTANT_SCALARS


class MimcHash256(Gadget):
    def __init__(self, image_lc=None):
        self.image = image_lc if image_lc is not None else to_lc(Scalar.zero())
        self.round_constants = round_constant_scalars()

    @staticmethod
    def init():
        return MimcHash256()

    def preprocess(self, witnesses):
        """Derive the padded last block (and the padding delta in the happy
        case) so padding honesty is provable."""
        derived = []
        last_block = witnesses[-1]
        last_le = remove_zero_padding(last_block.as_bytes())
        if len(last_le) < BLOCK_SIZE:
            padded_block = le_to_scalar(pkcs7_pad(last_le, BLOCK_SIZE))
            derived.append(padded_block)
            derived.append(padded_block - last_block)
        else:
            padding = le_to_scalar(bytes([32]) * 32)
            derived.append(padding)
        return derived

    def assemble(self, cs, witnesses, derived_witnesses):
        commitments = self._pad(cs, witnesses, derived_witnesses)
        hash_lc = self.mimc_sponge(cs, [v.lc() for v in commitments])
        # hash - image = 0
        cs.constrain(hash_lc - self.image.clone())

    def _pad(self, cs, witnesses, derived_witnesses):
        commitments = list(witnesses)
        _, padded_block = derived_witnesses[0]
        if len(derived_witnesses) == 2:
            # happy case: replace last witness with its padded form
            _, padding = derived_witnesses[1]
            last_block = commitments.pop()
            # honest padding: (last_block + padding) - padded_block = 0
            cs.constrain(last_block.lc() + padding.lc() - padded_block.lc())
        commitments.append(padded_block)
        return commitments

    def mimc_sponge(self, cs, preimage_lcs):
        key_zero = to_lc(Scalar.zero())
        state = to_lc(Scalar.zero())
        for lc in preimage_lcs:
            state = state + lc.clone()
            state = self.mimc_encryption(cs, state, key_zero.clone())
        return state

    def mimc_encryption(self, cs, p, k):
        p_v = p
        k_v = k
        for i in range(ROUNDS):
            ci = self.round_constants[i]
            p_plus_k_plus_ci = p_v.clone() + k_v.clone() + ci
            x_k_ci, _, sqr = cs.multiply(p_plus_k_plus_ci.clone(),
                                         p_plus_k_plus_ci)
            _, _, cube = cs.multiply(sqr.lc(), x_k_ci.lc())
            p_v = cube.lc()
        return p_v + k_v
