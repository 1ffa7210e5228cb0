"""n-bit range decomposition (reference src/utils.rs:5-35)."""

from ..core.scalar import Scalar


def range_proof(cs, x_lc, n: int, x_assignment):
    """Enforce x in [0, 2^n).  x_lc: LinearCombination; x_assignment:
    Scalar or None (verifier)."""
    exp_2 = Scalar.one()
    x_bytes = x_assignment.as_bytes() if x_assignment is not None else None
    for i in range(n):
        if x_bytes is not None:
            offset = i // 8
            bit = (x_bytes[offset] >> (i - offset * 8)) & 1
            assignment = (Scalar.from_int(1 - bit), Scalar.from_int(bit))
        else:
            assignment = None
        # recipe for the circuit-template cache (lang/template): this
        # multiplier is bit i of x_assignment
        a, b, o = cs.allocate_multiplier(
            assignment,
            _bit_source=(x_assignment, i) if x_assignment is not None
            else None)
        # o = a*b = 0 -> one of (a, b) is zero
        cs.constrain(o.lc())
        # a = 1 - b -> both are bits
        cs.constrain(a + (b - 1))
        x_lc = x_lc - b * exp_2
        exp_2 = exp_2 + exp_2
    # x = sum(b_i * 2^i)
    cs.constrain(x_lc)
