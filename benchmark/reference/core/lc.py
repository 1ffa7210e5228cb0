"""Variables and linear combinations over the constraint system.

Mirrors bulletproofs::r1cs::{Variable, LinearCombination} semantics (the
reference leans on them everywhere, e.g. src/utils.rs:5-35).  A
LinearCombination is an *ordered term list*; arithmetic concatenates terms
without canonicalization, exactly like the Rust type, so constraint
flattening accumulates identically.
"""

from .scalar import Scalar

# Variable kinds
ONE = 0
COMMITTED = 1
MULT_LEFT = 2
MULT_RIGHT = 3
MULT_OUT = 4


class Variable:
    __slots__ = ("kind", "index")

    def __init__(self, kind: int, index: int = 0):
        self.kind = kind
        self.index = index

    @staticmethod
    def one() -> "Variable":
        return Variable(ONE)

    def __eq__(self, other):
        return (isinstance(other, Variable) and self.kind == other.kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def __repr__(self):
        names = {ONE: "One", COMMITTED: "V", MULT_LEFT: "aL",
                 MULT_RIGHT: "aR", MULT_OUT: "aO"}
        return f"{names[self.kind]}({self.index})"

    # Variable -> LinearCombination sugar, matching the Rust From impls.
    def lc(self) -> "LinearCombination":
        return LinearCombination([(self, Scalar.one())])

    def __add__(self, other):
        return self.lc() + other

    def __sub__(self, other):
        return self.lc() - other

    def __mul__(self, scalar):
        return self.lc() * scalar

    def __neg__(self):
        return -self.lc()


def to_lc(value) -> "LinearCombination":
    if isinstance(value, LinearCombination):
        return value
    if isinstance(value, Variable):
        return value.lc()
    if isinstance(value, Scalar):
        return LinearCombination([(Variable.one(), value)])
    if isinstance(value, int):
        return LinearCombination([(Variable.one(), Scalar.from_int(value))])
    raise TypeError(f"cannot convert {value!r} to LinearCombination")


class LinearCombination:
    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = list(terms) if terms else []

    @staticmethod
    def zero() -> "LinearCombination":
        return LinearCombination()

    def __add__(self, other) -> "LinearCombination":
        other = to_lc(other)
        return LinearCombination(self.terms + other.terms)

    def __radd__(self, other):
        return to_lc(other) + self

    def __sub__(self, other) -> "LinearCombination":
        other = to_lc(other)
        return LinearCombination(
            self.terms + [(v, -c) for (v, c) in other.terms])

    def __rsub__(self, other):
        return to_lc(other) - self

    def __neg__(self) -> "LinearCombination":
        return LinearCombination([(v, -c) for (v, c) in self.terms])

    def __mul__(self, scalar) -> "LinearCombination":
        if isinstance(scalar, int):
            scalar = Scalar.from_int(scalar)
        return LinearCombination([(v, c * scalar) for (v, c) in self.terms])

    __rmul__ = __mul__

    def clone(self) -> "LinearCombination":
        return LinearCombination(list(self.terms))

    def __repr__(self):
        return " + ".join(f"{c.v}*{v}" for (v, c) in self.terms) or "0"
