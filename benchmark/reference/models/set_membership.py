"""SET_MEMBER gadget: member in {set}, via a committed one-hot selector
(reference src/set_membership/set_membership_gadget.rs)."""

from ..core.scalar import Scalar
from ..core.lc import LinearCombination
from .gadget import Gadget


class SetMembership(Gadget):
    def __init__(self, value_lc, value_assignment, instance_lcs,
                 instance_assignments):
        self.value = value_lc
        self.value_assignment = value_assignment
        self.instance_vars = instance_lcs
        self.instance_vars_assignments = instance_assignments

    def preprocess(self, witnesses):
        assert self.value_assignment is not None, "missing value assignment"
        assert self.instance_vars_assignments is not None, \
            "missing instance vars assignments"
        full_set = list(witnesses) + list(self.instance_vars_assignments)
        value = self.value_assignment
        derived = []
        for element in full_set:
            # dalek Scalar PartialEq compares raw byte encodings, so a
            # non-canonical from_bits witness is NOT equal to its reduced
            # twin; preserve that by comparing raw values.
            if element.v == value.v:
                derived.append(Scalar.one())
            else:
                derived.append(Scalar.zero())
        return derived

    def assemble(self, cs, witnesses, derived_witnesses):
        one_hot = []
        for _, bit in derived_witnesses:
            bit_lc = bit.lc()
            self._is_bit(cs, bit_lc)
            one_hot.append(bit_lc)

        self._one_hot_vector(cs, one_hot)

        full_set = [w.lc() for w in witnesses] + \
                   [lc.clone() for lc in self.instance_vars]
        self._hadamard_product(cs, one_hot, full_set, self.value.clone())

    @staticmethod
    def _one_hot_vector(cs, vector):
        total = LinearCombination.zero()
        for bit in vector:
            total = total + bit
        cs.constrain(Scalar.one() - total)

    @staticmethod
    def _is_bit(cs, bit_lc):
        one_minus_bit = Scalar.one() - bit_lc
        _, _, should_be_zero = cs.multiply(one_minus_bit, bit_lc)
        cs.constrain(should_be_zero.lc())

    @staticmethod
    def _hadamard_product(cs, vec_one, vec_two, expected):
        if len(vec_one) != len(vec_two):
            cs.constrain(Scalar.one())
            return
        actual = LinearCombination.zero()
        for a, b in zip(vec_one, vec_two):
            _, _, product = cs.multiply(a, b)
            actual = actual + product.lc()
        cs.constrain(expected - actual)
