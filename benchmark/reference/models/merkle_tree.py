"""MERKLE gadget: Merkle-tree membership with in-circuit MiMC sponge node
hashing (reference src/merkle_tree/merkle_tree_gadget.rs).

Pattern is the tree-shape AST: Hash(left, right) | W | I.  parse() consumes
witness/instance leaf queues in pattern order and emits one mimc_sponge per
Hash node; the root hash is constrained to equal `root`.
"""

from .gadget import Gadget
from .mimc_hash_gadget import MimcHash256

W = "W"
I = "I"


class Hash:
    __slots__ = ("left", "right")

    def __init__(self, left, right):
        self.left = left
        self.right = right

    def __repr__(self):
        return f"H({self.left!r} {self.right!r})"


class MerkleTree256(Gadget):
    def __init__(self, root_lc, instance_lcs, witness_lcs, pattern):
        self.root = root_lc
        self.instance_vars = instance_lcs
        self.witness_vars = witness_lcs
        self.pattern = pattern
        self.gadget = MimcHash256.init()

    def preprocess(self, _witnesses):
        return []

    def assemble(self, cs, _witnesses, _derived):
        w_values = [lc.clone() for lc in self.witness_vars]
        i_values = [lc.clone() for lc in self.instance_vars]
        hash_lc = self._parse(cs, w_values, i_values, self.pattern)
        cs.constrain(hash_lc - self.root.clone())

    def _parse(self, cs, w_vars, i_vars, pattern):
        if isinstance(pattern, Hash):
            left, right = pattern.left, pattern.right
            preimage = []
            for side in (left, right):
                if isinstance(side, Hash):
                    preimage.append(self._parse(cs, w_vars, i_vars, side))
                elif side == W:
                    preimage.append(self._next_val(w_vars))
                else:
                    preimage.append(self._next_val(i_vars))
        elif pattern == W:
            preimage = [self._next_val(w_vars)]
        else:
            preimage = [self._next_val(i_vars)]
        return self.gadget.mimc_sponge(cs, preimage)

    @staticmethod
    def _next_val(values):
        assert values, \
            "too few variables provided to satisfy the given pattern"
        return values.pop(0)
