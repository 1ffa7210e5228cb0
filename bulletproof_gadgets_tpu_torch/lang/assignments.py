"""Symbol table for instance/witness/commitment assignments
(reference src/lalrpop/assignment_parser.rs).

Key formats (assignment_parser.rs:65-86, 199-206):
  C{n}-{limb}               witness commitment, limb-indexed
  D{gadget}-{subroutine}-{i} gadget-derived commitment
"""

from .parser import parse_assignment
from ..utils.conversions import be_to_scalars
from ..utils import rng


def format_com(identifier: str, gadget_no: str, com_idx: int,
               com: bytes) -> str:
    return f"{identifier}{gadget_no}-{com_idx} = 0x{com.hex()}\n"


def assert_32(name, assignment: bytes):
    assert len(assignment) <= 32, \
        f"instance var {name} is longer than 32 bytes"


def assert_witness_32(name, assignment):
    assert len(assignment[0]) == 1, \
        f"witness var {name} is longer than 32 bytes"


class Assignments:
    def __init__(self):
        self.commitments = {}      # key -> Variable (verifier side)
        self.witness_vars = {}     # name -> (scalars, coms, vars, bytes)
        self.derived_witnesses = []  # list[Scalar] (prover cache)
        self.instance_vars = {}    # name -> bytes

    # -- instance ----------------------------------------------------------
    def parse_instance(self, instance: str) -> None:
        for line in instance.splitlines():
            if not line.strip():
                continue
            name, data = parse_assignment(line)
            self.instance_vars[name] = data

    def get_instance(self, var, assertion=None) -> bytes:
        assert var.is_instance(), "provided variable is not of type instance"
        if var.name not in self.instance_vars:
            raise KeyError(f"missing instance var {var.name}")
        data = self.instance_vars[var.name]
        if assertion:
            assertion(var.name, data)
        return data

    # -- witness (prover side) ---------------------------------------------
    def parse_witness(self, witness: str, prover, coms_out: list) -> None:
        """Commit every witness var on the main prover; append C-lines to
        coms_out (list of strings)."""
        for line in witness.splitlines():
            if not line.strip():
                continue
            name, data = parse_assignment(line)
            scalars = be_to_scalars(data)
            coms, variables = [], []
            for scalar in scalars:
                com, v = prover.commit(scalar, rng.random_scalar())
                coms.append(com)
                variables.append(v)
            self.witness_vars[name] = (scalars, coms, variables, data)
            for index, com in enumerate(coms):
                coms_out.append(format_com("C", name[1:], index, com))

    def get_witness(self, var, assertion=None):
        assert var.is_witness(), "provided variable is not of type witness"
        if var.name not in self.witness_vars:
            raise KeyError(f"missing witness var {var.name}")
        assignment = self.witness_vars[var.name]
        if assertion:
            assertion(var.name, assignment)
        return assignment

    # -- derived (prover side) ---------------------------------------------
    def cache_derived_wtns(self, derived_witnesses) -> None:
        for scalar, _var in derived_witnesses:
            assert scalar is not None
            self.derived_witnesses.append(scalar)

    def parse_derived_witness(self, coms, gadget: int, subroutine: int,
                              coms_out: list) -> None:
        for index, com in enumerate(coms):
            identifier = f"{gadget}-{subroutine}"
            coms_out.append(format_com("D", identifier, index, com))

    # -- commitments (verifier side) ---------------------------------------
    def parse_commitments(self, commitments: str, verifier) -> None:
        for line in commitments.splitlines():
            if not line.strip():
                continue
            name, data = parse_assignment(line)
            self.commitments[name] = verifier.commit(data)

    def inquire_commitment(self, var, index: int):
        key = f"C{var.name[1:]}-{index}"
        return self.commitments.get(key)

    def get_commitment(self, var, index: int):
        com = self.inquire_commitment(var, index)
        if com is None:
            raise KeyError(f"missing commitment C{var.name[1:]}-{index}")
        return com

    def get_all_commitments(self, var):
        variables = []
        index = 0
        while True:
            com = self.inquire_commitment(var, index)
            if com is None:
                break
            variables.append(com)
            index += 1
        return variables

    def inquire_derived(self, gadget: int, index: int, subroutine: int):
        return self.commitments.get(f"D{gadget}-{subroutine}-{index}")

    def get_derived(self, gadget: int, index: int, subroutine: int):
        v = self.inquire_derived(gadget, index, subroutine)
        if v is None:
            raise KeyError(f"missing commitment D{gadget}-{subroutine}-{index}")
        return v
