"""Operation-recording constraint system (redesign of reference
src/cs_buffer.rs).

The reference wraps a throwaway `Prover` on a separate "BufferTranscript" so
recorded operations mint correct variable indices (cs_buffer.rs:37-41,
prove.rs:53-59).  Here no shadow prover is needed: the recorder mints
MULT_* indices itself from a counter, records the op log, and `replay_into`
applies the log to the real Prover/Verifier at the end (prove.rs:72,84-99).
Re-evaluation of Multiply assignments happens at replay time inside the real
prover, which is also where the reference's correctness actually comes from.

OR scoping (rewind / initialize_from / buffer_cache) keeps the reference's
observable behavior: each `{...}` clause snapshot is one op-log entry in
`cached_buffers`; nested ORs initialize from the full ancestor logs so their
minted indices line up with the final replay order (cs_buffer.rs:49-71).
"""

from .lc import Variable, to_lc, MULT_LEFT, MULT_RIGHT, MULT_OUT
from .r1cs import R1CSError

OP_MULTIPLY = 0
OP_ALLOCATE = 1
OP_CONSTRAIN = 2
OP_COMMIT = 3


class RecordingCS:
    """ConstraintSystem that records; prover/verifier mode differ only in
    whether allocate_multiplier carries assignments."""

    def __init__(self, prover_mode: bool, initial_mults: int = 0):
        self.prover_mode = prover_mode
        self.num_mults = initial_mults
        self.operation_buffer = []
        self.cached_buffers = []

    # -- ConstraintSystem surface -----------------------------------------
    def multiply(self, left, right):
        left = to_lc(left)
        right = to_lc(right)
        self.operation_buffer.append((OP_MULTIPLY, (left, right)))
        return self._mint()

    def allocate_multiplier(self, assignment, _bit_source=None):
        """_bit_source: optional (scalar, bit_index) recipe threaded by
        range_proof so lang/template can replay the allocation for a new
        witness (bit extraction from the re-committed scalar)."""
        if self.prover_mode:
            if assignment is None:
                raise R1CSError("missing assignment")
            self.operation_buffer.append(
                (OP_ALLOCATE, (assignment, _bit_source)))
        else:
            self.operation_buffer.append((OP_ALLOCATE, (None, _bit_source)))
        return self._mint()

    def constrain(self, lc):
        self.operation_buffer.append((OP_CONSTRAIN, to_lc(lc)))

    def commit_drvd(self, derived_witnesses):
        """Record that derived witnesses were committed (scalars only matter
        for parity with the reference's op log)."""
        scalars = [d[0] for d in derived_witnesses]
        self.operation_buffer.append((OP_COMMIT, scalars))

    def _mint(self):
        i = self.num_mults
        self.num_mults += 1
        return (Variable(MULT_LEFT, i), Variable(MULT_RIGHT, i),
                Variable(MULT_OUT, i))

    # -- scoping (OR support) ---------------------------------------------
    def rewind(self):
        self.cached_buffers.append(self.operation_buffer)
        self.operation_buffer = []

    def buffer(self):
        return self.operation_buffer

    def buffer_cache(self):
        return self.cached_buffers

    def initialize_from(self, initialization):
        """Replay ancestor op logs (index alignment only, nothing recorded)."""
        for operations in initialization:
            for op, _payload in operations:
                if op in (OP_MULTIPLY, OP_ALLOCATE):
                    self.num_mults += 1

    # -- final replay ------------------------------------------------------
    def replay_into(self, cs):
        """Apply the recorded top-level ops to the real Prover/Verifier."""
        for op, payload in self.operation_buffer:
            if op == OP_MULTIPLY:
                left, right = payload
                cs.multiply(left, right)
            elif op == OP_ALLOCATE:
                cs.allocate_multiplier(payload[0])
            elif op == OP_CONSTRAIN:
                cs.constrain(payload)
            # OP_COMMIT: nop — commits were applied to the main CS live.
