"""LESS_THAN gadget: LEFT < RIGHT, both in [0, 2^126)
(reference src/less_than/less_than_gadget.rs)."""

from ..core.scalar import Scalar
from .gadget import Gadget
from .range_proof import range_proof

N_BITS = 126


class LessThan(Gadget):
    def __init__(self, left_lc, left_assignment, right_lc, right_assignment):
        self.left_hand = left_lc
        self.left_hand_assignment = left_assignment
        self.right_hand = right_lc
        self.right_hand_assignment = right_assignment

    def preprocess(self, _witnesses):
        assert self.left_hand_assignment is not None, \
            "missing left hand assignment"
        assert self.right_hand_assignment is not None, \
            "missing right hand assignment"
        delta = self.right_hand_assignment - self.left_hand_assignment
        derived = [delta]
        if delta.canonical == 0:
            derived.append(Scalar.zero())
        else:
            derived.append(delta.invert())
        return derived

    def assemble(self, cs, _witnesses, derived_witnesses):
        delta_assignment, delta = derived_witnesses[0]
        _, delta_inv = derived_witnesses[1]

        # left, right, delta all in [0, 2^126)
        range_proof(cs, self.left_hand.clone(), N_BITS,
                    self.left_hand_assignment)
        range_proof(cs, self.right_hand.clone(), N_BITS,
                    self.right_hand_assignment)
        range_proof(cs, delta.lc(), N_BITS, delta_assignment)

        # delta * delta_inv = 1 -> delta != 0
        _, _, should_be_one = cs.multiply(delta.lc(), delta_inv.lc())
        cs.constrain(Scalar.one() - should_be_one.lc())

        # right - left - delta = 0
        cs.constrain(self.right_hand.clone() - self.left_hand.clone()
                     - delta.lc())
