"""Gadget-language AST (reference src/lalrpop/ast.rs)."""

OR = "OR"
HASH = "HASH"
BOUND = "BOUND"
MERKLE = "MERKLE"
LESS_THAN = "LESS_THAN"
EQUALS = "EQUALS"
UNEQUAL = "UNEQUAL"
SET_MEMBER = "SET_MEMBER"
ARRAY_START = "["
ARRAY_END = "]"
BLOCK_START = "{"
BLOCK_END = "}"

GADGET_OPS = {OR, HASH, BOUND, MERKLE, LESS_THAN, EQUALS, UNEQUAL,
              SET_MEMBER, ARRAY_START, ARRAY_END, BLOCK_START, BLOCK_END}


class Var:
    """Instance ("I3") or Witness ("W1") reference."""
    __slots__ = ("kind", "name")

    INSTANCE = "I"
    WITNESS = "W"

    def __init__(self, kind, name):
        self.kind = kind
        self.name = name  # full token, e.g. "W1"

    @property
    def number(self) -> str:
        return self.name[1:]

    def is_witness(self):
        return self.kind == Var.WITNESS

    def is_instance(self):
        return self.kind == Var.INSTANCE

    def __repr__(self):
        return self.name


def get_gadget_op(line: str) -> str:
    """First whitespace token; raises on unknown ops (reference
    prove.rs:136-140 panics with 'unknown gadget')."""
    token = line.split()[0] if line.split() else ""
    if token not in GADGET_OPS:
        raise ValueError(f"unknown gadget: {token}")
    return token
