"""Circuit template cache: constraint STRUCTURE is static per
(.gadgets, .inst, witness-shape) triple — only assignments change.

Round-3 profiling: ~2.1 s of every warm merkle prove was host Python
re-deriving the identical constraint system — gadget assemble()
LinearCombination churn, recorder op logging, and the replay into the real
prover (docs/PERFORMANCE.md round-4 queue #3).  The reference rebuilds its
system per prove too (src/prove.rs:62-72), but it pays ~nothing because
Rust; for the TPU port the rebuild became the serial host floor capping
both warm latency and batched-witness throughput (lang/batch.py drives
prove_prepared per witness).

A CircuitTemplate freezes, after one full assembly:
  * the prover/verifier constraint list (shared by reference — immutable),
  * per-multiplier evaluation programs: the ORIGINAL left/right LC terms
    as (kind, index, coeff) triples, evaluated sequentially against the
    committed values + previously-filled multiplier slots,
  * bit-allocation recipes for range proofs: `allocate_multiplier` sites
    record which committed scalar and bit position they decompose
    (models/range_proof.py threads `_bit_source`), replayed as bit
    extraction from the new witness's committed values.

Cache keys: the prover keys on (gadgets, instance, per-witness byte
lengths) — every structural branch in the gadget zoo (equality poison,
set-membership hashing, MiMC padding, limb counts) depends on lengths,
never on values; the verifier keys on (gadgets, instance, the ordered
commitment KEY names), which encode the same shape information from the
.coms side.  BPG_TPU_TEMPLATE_CACHE=0 disables.
"""
import os

from ..core.scalar import Scalar, L
from ..core.lc import ONE, COMMITTED, MULT_LEFT, MULT_RIGHT, MULT_OUT

_OP_MUL = 0
_OP_BITS = 1


class CircuitTemplate:
    __slots__ = ("constraints", "mults", "num_mults", "nv")

    def __init__(self, constraints, mults, num_mults, nv):
        self.constraints = constraints   # list[LinearCombination], FROZEN
        self.mults = mults               # [(_OP_MUL, lt, rt) | (_OP_BITS, slot, bit)]
        self.num_mults = num_mults
        self.nv = nv                     # committed-value count at build

    def fill_assignments(self, prover):
        """Compute a_L/a_R/a_O for a fresh witness by evaluating the cached
        multiplier programs against prover.v (committed values, same order
        as at build time)."""
        assert len(prover.v) == self.nv, (len(prover.v), self.nv)
        v = [s.v for s in prover.v]
        aL, aR, aO = [], [], []

        def ev(terms):
            acc = 0
            for kind, idx, c in terms:
                if kind == COMMITTED:
                    acc += c * v[idx]
                elif kind == MULT_LEFT:
                    acc += c * aL[idx]
                elif kind == MULT_RIGHT:
                    acc += c * aR[idx]
                elif kind == MULT_OUT:
                    acc += c * aO[idx]
                else:
                    acc += c
            return acc % L

        for op in self.mults:
            if op[0] == _OP_MUL:
                l = ev(op[1])
                r = ev(op[2])
            else:
                _, slot, bit = op
                b = (v[slot] >> bit) & 1
                l, r = 1 - b, b
            aL.append(l)
            aR.append(r)
            aO.append(l * r % L)

        prover.a_L = [Scalar(x) for x in aL]
        prover.a_R = [Scalar(x) for x in aR]
        prover.a_O = [Scalar(x) for x in aO]
        # constraints are shared and never mutated downstream
        prover.constraints = self.constraints


def _terms(lc):
    return [(var.kind, var.index, coeff.v % L) for var, coeff in lc.terms]


def build_prover_template(recorder, prover):
    """Freeze a template from a completed assembly (recorder op log +
    replayed prover).  Returns None when a bit-allocation site lacks a
    recipe or decomposes an uncommitted scalar (no current gadget does —
    safety fallback, not an expected path)."""
    from ..core.recorder import OP_MULTIPLY, OP_ALLOCATE

    # Bind bit recipes to committed slots by object IDENTITY, never by
    # value: two distinct committed scalars can be equal at build time
    # (EQUALS statements, repeated bounds), and a value-keyed map would
    # silently bind a recipe to the wrong slot — poisoning every later
    # cache hit whose witness makes those slots differ.  Scalar
    # constructors never intern (core/scalar.py), and the gadget zoo
    # threads the exact committed objects through _bit_source
    # (assignments.parse_witness / Gadget.setup store what they commit),
    # so identity is both safe and precise.  All objects are alive for
    # the duration of this map — no id-recycling window.
    vmap = {}
    for i, s in enumerate(prover.v):
        vmap.setdefault(id(s), i)
    mults = []
    for op, payload in recorder.operation_buffer:
        if op == OP_MULTIPLY:
            left, right = payload
            mults.append((_OP_MUL, _terms(left), _terms(right)))
        elif op == OP_ALLOCATE:
            _assignment, source = payload
            if source is None:
                return None                      # no recipe recorded
            x_scalar, bit = source
            slot = vmap.get(id(x_scalar))
            if slot is None:
                return None                      # uncommitted source
            mults.append((_OP_BITS, slot, bit))
    return CircuitTemplate(prover.constraints, mults,
                           len(prover.a_L), len(prover.v))


class VerifierTemplate:
    __slots__ = ("constraints", "num_vars")

    def __init__(self, constraints, num_vars):
        self.constraints = constraints
        self.num_vars = num_vars

    def apply(self, verifier):
        verifier.constraints = self.constraints
        verifier.num_vars = self.num_vars


def enabled() -> bool:
    return os.environ.get("BPG_TPU_TEMPLATE_CACHE", "1") == "1"


def witness_shape(witness: str):
    """Per-witness-var byte lengths — the prover-side shape key."""
    shape = []
    for line in witness.splitlines():
        line = line.strip()
        if not line:
            continue
        name, _, data = line.partition("=")
        shape.append((name.strip(), len(data.strip()) // 2))
    return tuple(shape)


def commitment_shape(commitments: str):
    """Ordered commitment key names — the verifier-side shape key."""
    keys = []
    for line in commitments.splitlines():
        line = line.strip()
        if not line:
            continue
        name, _, _ = line.partition("=")
        keys.append(name.strip())
    return tuple(keys)


class _LRU:
    def __init__(self, cap=32):
        self.cap = cap
        self.d = {}

    def get(self, k):
        v = self.d.pop(k, None)
        if v is not None:
            self.d[k] = v
        return v

    def put(self, k, v):
        self.d.pop(k, None)
        self.d[k] = v
        while len(self.d) > self.cap:
            self.d.pop(next(iter(self.d)))


prover_cache = _LRU()
verifier_cache = _LRU()
