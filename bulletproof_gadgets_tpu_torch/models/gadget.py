"""Gadget lifecycle (reference src/gadget.rs:7-60).

preprocess: derive auxiliary witness scalars from real ones.
setup:      Pedersen-commit each derived witness on the *main* prover with a
            fresh random blinding; returns (coms, [(Some(scalar), var), ...]).
assemble:   emit constraints against a ConstraintSystem — called by prove()
            with assignments and by verify() with None assignments (the
            single-definition / two-interpretation property).
"""

from ..utils import rng


class Gadget:
    def preprocess(self, witnesses):
        raise NotImplementedError

    def assemble(self, cs, witnesses, derived_witnesses):
        raise NotImplementedError

    def setup(self, prover, witnesses):
        derived_scalars = self.preprocess(witnesses)
        commitments = []
        derived_witnesses = []
        for scalar in derived_scalars:
            com, var = prover.commit(scalar, rng.random_scalar())
            commitments.append(com)
            derived_witnesses.append((scalar, var))
        return commitments, derived_witnesses

    def prove(self, cs, commitment_vars, derived_witnesses):
        self.assemble(cs, commitment_vars, derived_witnesses)

    def verify(self, cs, witnesses, derived):
        derived_witnesses = [(None, var) for var in derived]
        self.assemble(cs, witnesses, derived_witnesses)
