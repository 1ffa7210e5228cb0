"""UNEQUAL gadget: multi-limb LEFT != RIGHT
(reference src/inequality/inequality_gadget.rs)."""

from ..core.scalar import Scalar
from ..core.lc import LinearCombination
from .gadget import Gadget


def compare(left: Scalar, right: Scalar) -> bool:
    """Byte-wise big-endian >= on the raw (possibly unreduced) encodings
    (inequality_gadget.rs:103-113); equivalent to integer compare of raws."""
    return left.v >= right.v


class Inequality(Gadget):
    def __init__(self, right_hand, right_hand_assignment=None):
        self.right_hand = right_hand  # list[LinearCombination]
        self.right_hand_assignment = right_hand_assignment  # list[Scalar]|None

    def preprocess(self, left_hand):
        assert self.right_hand_assignment is not None, \
            "missing right hand assignment"
        right_hand = self.right_hand_assignment
        derived = []
        total = Scalar.zero()
        for i, left in enumerate(left_hand):
            right = right_hand[i] if i < len(right_hand) else Scalar.zero()
            if compare(left, right):
                delta = left - right
            else:
                delta = right - left
            derived.append(delta)
            if delta.canonical == 0:
                derived.append(Scalar.zero())
            else:
                delta_inv = delta.invert()
                derived.append(delta_inv)
                total = total + delta * delta_inv
        derived.append(total.invert())
        return derived

    def assemble(self, cs, left_hand, derived_witnesses):
        if len(self.right_hand) != len(left_hand):
            # mismatch: reference constrains 0 = 0 (vacuous, line 54)
            cs.constrain(Scalar.zero())
            return
        total = LinearCombination.zero()
        for i, left in enumerate(left_hand):
            right_lc = self.right_hand[i]
            left_lc = left.lc()
            _, delta = derived_witnesses[i * 2]
            _, delta_inv = derived_witnesses[i * 2 + 1]
            # (left - right - delta) * (right - left - delta) = 0
            lhs = left_lc - right_lc - delta
            rhs = right_lc - left_lc - delta
            _, _, should_be_zero = cs.multiply(lhs, rhs)
            cs.constrain(should_be_zero.lc())
            # delta * delta_inv is 1 iff delta != 0
            _, _, zero_or_one = cs.multiply(delta.lc(), delta_inv.lc())
            total = total + zero_or_one
        _, sum_inv = derived_witnesses[-1]
        _, _, should_be_one = cs.multiply(total, sum_inv.lc())
        # sum * sum_inv = 1 -> at least one limb differs
        cs.constrain(Scalar.one() - should_be_one.lc())
