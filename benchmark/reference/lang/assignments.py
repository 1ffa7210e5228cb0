"""Symbol table for instance/witness/commitment assignments
(reference src/lalrpop/assignment_parser.rs).

Key formats (assignment_parser.rs:65-86, 199-206):
  C{n}-{limb}               witness commitment, limb-indexed
  D{gadget}-{subroutine}-{i} gadget-derived commitment
"""

from .parser import parse_assignment


def assert_32(name, assignment: bytes):
    assert len(assignment) <= 32, \
        f"instance var {name} is longer than 32 bytes"


class Assignments:
    def __init__(self):
        self.commitments = {}      # key -> Variable (verifier side)
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
