"""EQUALS gadget: limb-wise LEFT = RIGHT
(reference src/equality/equality_gadget.rs)."""

from ..core.scalar import Scalar
from .gadget import Gadget


class Equality(Gadget):
    def __init__(self, right_hand):
        # right_hand: list[LinearCombination]
        self.right_hand = right_hand

    def preprocess(self, witnesses):
        return []

    def assemble(self, cs, left_hand, _derived):
        if len(self.right_hand) != len(left_hand):
            # length mismatch poisons the circuit: constrain 1 = 0
            cs.constrain(Scalar.one())
            return
        for left, right in zip(left_hand, self.right_hand):
            cs.constrain(right - left.lc())
