"""Gadget lifecycle, verifier side only (reference src/gadget.rs:7-60).

preprocess: derive auxiliary witness scalars from real ones.
assemble:   emit constraints against a ConstraintSystem, called by verify()
            with None assignments.
"""


class Gadget:
    def preprocess(self, witnesses):
        raise NotImplementedError

    def assemble(self, cs, witnesses, derived_witnesses):
        raise NotImplementedError

    def verify(self, cs, witnesses, derived):
        derived_witnesses = [(None, var) for var in derived]
        self.assemble(cs, witnesses, derived_witnesses)
