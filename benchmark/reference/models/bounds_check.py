"""BOUND gadget: min <= v <= max
(reference src/bounds_check/bounds_check_gadget.rs)."""

from ..utils.conversions import be_to_scalar
from .gadget import Gadget
from .range_proof import range_proof


class BoundsCheck(Gadget):
    def __init__(self, min_bytes: bytes, max_bytes: bytes):
        # number of bits sized by the byte length of max
        self.n = len(max_bytes) * 8
        self.min = be_to_scalar(min_bytes)
        self.max = be_to_scalar(max_bytes)

    def preprocess(self, witnesses):
        v = witnesses[0]
        return [v - self.min, self.max - v]

    def assemble(self, cs, _witnesses, derived_witnesses):
        a_assignment, a = derived_witnesses[0]
        b_assignment, b = derived_witnesses[1]
        a_lc = a.lc()
        b_lc = b.lc()
        # (a + b) - (max - min) = 0
        cs.constrain(a_lc + b_lc - (self.max - self.min))
        range_proof(cs, a.lc(), self.n, a_assignment)
        range_proof(cs, b.lc(), self.n, b_assignment)
