"""Prover orchestrator for `.gadgets` statements
(reference src/prove.rs — same call stack, SURVEY.md §3.1).

Host sequencing only: parsing, symbol table, transcript interleaving and the
operation log live here; all heavy math happens inside core.r1cs.Prover /
core.ipa via the registered device engine (ops/engine).
"""
import math

from ..core.gens import PedersenGens, BulletproofGens
from ..core.r1cs import Prover
from ..core.recorder import RecordingCS, OP_COMMIT
from ..core.lc import to_lc
from ..core.scalar import Scalar
from ..utils.merlin import new_transcript as Transcript
from ..utils.conversions import be_to_scalar, be_to_scalars, scalar_to_be
from ..utils import rng
from ..ops import engine
from ..models.bounds_check import BoundsCheck
from ..models.equality import Equality
from ..models.inequality import Inequality
from ..models.less_than import LessThan
from ..models.set_membership import SetMembership
from ..models.mimc_hash_gadget import MimcHash256
from ..models.merkle_tree import MerkleTree256
from ..models.mimc import mimc_hash
from ..models.or_conjunction import or_gadget
from .ast import (get_gadget_op, OR, HASH, BOUND, MERKLE, LESS_THAN, EQUALS,
                  UNEQUAL, SET_MEMBER, ARRAY_END, BLOCK_END)
from .assignments import Assignments, assert_32, assert_witness_32
from . import parser
from . import template


def round_pow2(num: int) -> int:
    """2^ceil(log2(num)) (reference prove.rs:33-35)."""
    if num <= 1:
        return 1
    return 1 << math.ceil(math.log2(num))


def _gprove(gadget, recorder, variables, wtns):
    """gadget.prove unless the recorder is in template-hit mode (the
    constraint structure is cached; only setup side effects run)."""
    if getattr(recorder, "skip_assembly", False):
        return
    gadget.prove(recorder, variables, wtns)


def commit_single(prover, witness: bytes):
    """commitments.rs:23-31."""
    assert len(witness) <= 32, "witness longer than 32 bytes"
    scalar = be_to_scalar(witness)
    commitment, variable = prover.commit(scalar, rng.random_scalar())
    return scalar, commitment, variable


def prove_prepared(name: str, instance: str, witness: str, gadgets: str,
                   coms_out: list, device=None):
    """Everything in prove() up to (not including) the final prover.prove:
    parsing, witness commitments, gadget assembly, buffer replay, gens
    sizing.  Returns (prover, bp_gens, num_constraints) so callers can run
    the proof phase themselves — lang.batch drives many prepared provers in
    lockstep over combined MSM launches.

    The constraint structure is cached per (gadgets, instance,
    witness-shape): on a hit, gadget assembly and replay are skipped
    entirely — setup/commit side effects still run live, assignments are
    evaluated from the cached multiplier programs (lang/template).
    Generators not cached yet are mapped on `device`, as in prove()."""
    transcript = Transcript(name.encode())
    pc_gens = PedersenGens.default()
    prover = Prover(pc_gens, transcript)

    assignments = Assignments()
    assignments.parse_instance(instance)
    assignments.parse_witness(witness, prover, coms_out)

    cache_key = None
    tmpl = None
    if template.enabled():
        cache_key = (gadgets, instance, template.witness_shape(witness))
        tmpl = template.prover_cache.get(cache_key)

    recorder = RecordingCS(prover_mode=True)
    if tmpl is not None:
        recorder.skip_assembly = True

    lines = _peekable(enumerate(gadgets.splitlines()))
    while lines.peek() is not None:
        index, line = lines.next()
        local_initialization = [list(recorder.buffer())]
        _parse_conjunction(lines, line, assignments, prover, recorder,
                           coms_out, local_initialization)
        _parse_gadget(line, assignments, prover, recorder, index, coms_out)

    if tmpl is not None:
        tmpl.fill_assignments(prover)
    else:
        recorder.replay_into(prover)
        if cache_key is not None:
            built = template.build_prover_template(recorder, prover)
            if built is not None:
                template.prover_cache.put(cache_key, built)

    num_constraints = prover.num_constraints()
    bp_gens = BulletproofGens(round_pow2(prover.get_num_multiplications()), 1,
                              device=engine.use(device))
    return prover, bp_gens, num_constraints


def prove(name: str, instance: str, witness: str, gadgets: str,
          coms_out: list, device=None):
    """Returns proof bytes; appends commitment lines to coms_out.

    Mirrors prove() at src/prove.rs:37-82; returns (proof_bytes,
    num_constraints).  The device work runs on `device` ("cuda", "cpu",
    ...), else on the device registered before (ops/engine), else on CUDA,
    which raises where CUDA is missing."""
    device = engine.use(device)
    prover, bp_gens, num_constraints = prove_prepared(
        name, instance, witness, gadgets, coms_out, device)
    proof = prover.prove(bp_gens)
    return proof.to_bytes(), num_constraints


class _peekable:
    def __init__(self, it):
        self._it = iter(it)
        self._peeked = None
        self._has = False

    def peek(self):
        if not self._has:
            try:
                self._peeked = next(self._it)
                self._has = True
            except StopIteration:
                return None
        return self._peeked

    def next(self):
        v = self.peek()
        if v is None:
            raise StopIteration
        self._has = False
        return v


def _parse_gadget(line, assignments, prover, recorder, index, coms_out):
    op = get_gadget_op(line)
    if op == BOUND:
        _bounds_check_gadget(line, assignments, prover, recorder, index,
                             coms_out)
    elif op == HASH:
        _mimc_hash_gadget(line, assignments, prover, recorder, index,
                          coms_out)
    elif op == MERKLE:
        _merkle_tree_gadget(line, assignments, prover, recorder, index,
                            coms_out)
    elif op == EQUALS:
        _equality_gadget(line, assignments, recorder)
    elif op == LESS_THAN:
        _less_than_gadget(line, assignments, prover, recorder, index,
                          coms_out)
    elif op == UNEQUAL:
        _inequality_gadget(line, assignments, prover, recorder, index,
                           coms_out)
    elif op == SET_MEMBER:
        _set_membership_gadget(line, assignments, prover, recorder, index,
                               coms_out)
    # OR / brackets handled by _parse_conjunction


def _parse_conjunction(lines, line, assignments, prover, recorder, coms_out,
                       initialization):
    if get_gadget_op(line) == OR:
        _or_conjunction(lines, assignments, prover, recorder, coms_out,
                        initialization)


def _or_conjunction(lines, assignments, prover, parent_recorder, coms_out,
                    initialization):
    """prove.rs:184-220; the shadow 'OrTranscript' prover is replaced by a
    scoped RecordingCS whose multiplier counter is initialized from the
    ancestor op logs."""
    recorder = RecordingCS(prover_mode=True)
    recorder.skip_assembly = getattr(parent_recorder, "skip_assembly", False)
    recorder.initialize_from(initialization)

    if lines.peek() is None:
        raise ValueError("unexpected end of input")

    while lines.peek() is not None:
        local_index, line = lines.next()
        op = get_gadget_op(line)
        if op == ARRAY_END:
            break
        if op == BLOCK_END:
            recorder.rewind()
        else:
            local_initialization = list(initialization)
            local_initialization.append(list(recorder.buffer()))
            _parse_conjunction(lines, line, assignments, prover, recorder,
                               coms_out, local_initialization)
            _parse_gadget(line, assignments, prover, recorder, local_index,
                          coms_out)

    _add_commitments_to_parent(parent_recorder, recorder)
    if not getattr(recorder, "skip_assembly", False):
        or_gadget(parent_recorder, recorder)


def _add_commitments_to_parent(parent, buffer):
    for operations in buffer.buffer_cache():
        for op, payload in operations:
            if op == OP_COMMIT:
                parent.commit_drvd([(s, None) for s in payload])


def _hash_witness(prover, recorder, var, assignments, index, subroutine,
                  coms_out):
    """Sub-proof: commit MiMC image of a (multi-limb) witness and prove the
    hash in-circuit (prove.rs:142-172)."""
    hash_commitments = []
    preimage_scalars, _, preimage_vars, preimage_bytes = \
        assignments.get_witness(var, None)
    image = mimc_hash(preimage_bytes)

    image_scalar, image_com, image_var = commit_single(
        prover, scalar_to_be(image))
    image_drvd = [(image_scalar, image_var)]
    recorder.commit_drvd(image_drvd)
    assignments.cache_derived_wtns(image_drvd)
    hash_commitments.append(image_com)

    hash_gadget = MimcHash256(image_var.lc())
    derived_coms, derived_wtns = hash_gadget.setup(prover, preimage_scalars)
    recorder.commit_drvd(derived_wtns)
    _gprove(hash_gadget, recorder, preimage_vars, derived_wtns)
    hash_commitments.extend(derived_coms)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(hash_commitments, index, subroutine,
                                      coms_out)
    return image_scalar, image_var


def _hash_instance(var, assignments):
    data = assignments.get_instance(var, None)
    image = mimc_hash(data)
    return image, to_lc(image)


def _bounds_check_gadget(line, assignments, prover, recorder, index,
                         coms_out):
    var, mn, mx = parser.parse_bound(line)
    witness = assignments.get_witness(var, assert_witness_32)
    mn_b = assignments.get_instance(mn, assert_32)
    mx_b = assignments.get_instance(mx, assert_32)

    gadget = BoundsCheck(mn_b, mx_b)
    derived_coms, derived_wtns = gadget.setup(prover, witness[0])
    recorder.commit_drvd(derived_wtns)
    _gprove(gadget, recorder, witness[2], derived_wtns)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(derived_coms, index, 0, coms_out)


def _mimc_hash_gadget(line, assignments, prover, recorder, index, coms_out):
    image, preimage = parser.parse_hash(line)

    if image.is_witness():
        image_lc = assignments.get_witness(image, assert_witness_32)[2][0].lc()
    else:
        image_lc = to_lc(be_to_scalar(
            assignments.get_instance(image, assert_32)))

    preimage_w = assignments.get_witness(preimage, None)

    gadget = MimcHash256(image_lc)
    derived_coms, derived_wtns = gadget.setup(prover, preimage_w[0])
    recorder.commit_drvd(derived_wtns)
    _gprove(gadget, recorder, preimage_w[2], derived_wtns)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(derived_coms, index, 0, coms_out)


def _merkle_tree_gadget(line, assignments, prover, recorder, index,
                        coms_out):
    root, instance_vars, witness_vars, pattern = parser.parse_merkle(line)

    if root.is_witness():
        root_lc = assignments.get_witness(root, assert_witness_32)[2][0].lc()
    else:
        root_lc = to_lc(be_to_scalar(
            assignments.get_instance(root, assert_32)))

    instance_lcs = [to_lc(mimc_hash(assignments.get_instance(v, None)))
                    for v in instance_vars]

    witness_lcs = []
    for hash_number, wvar in enumerate(witness_vars):
        _, var = _hash_witness(prover, recorder, wvar, assignments, index,
                               hash_number, coms_out)
        witness_lcs.append(var.lc())

    gadget = MerkleTree256(root_lc, instance_lcs, witness_lcs, pattern)
    _gprove(gadget, recorder, [], [])


def _equality_gadget(line, assignments, recorder):
    left, right = parser.parse_equality(line)
    _, _, left_vars, _ = assignments.get_witness(left, None)

    if right.is_witness():
        right_lcs = [v.lc() for v in assignments.get_witness(right, None)[2]]
    else:
        right_lcs = [to_lc(s) for s in be_to_scalars(
            assignments.get_instance(right, None))]

    gadget = Equality(right_lcs)
    _gprove(gadget, recorder, left_vars, [])


def _less_than_gadget(line, assignments, prover, recorder, index, coms_out):
    left, right = parser.parse_less_than(line)
    left_scalars, _, left_vars, _ = assignments.get_witness(
        left, assert_witness_32)
    right_scalars, _, right_vars, _ = assignments.get_witness(
        right, assert_witness_32)

    gadget = LessThan(left_vars[0].lc(), left_scalars[0],
                      right_vars[0].lc(), right_scalars[0])
    derived_coms, derived_wtns = gadget.setup(prover, [])
    recorder.commit_drvd(derived_wtns)
    _gprove(gadget, recorder, [], derived_wtns)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(derived_coms, index, 0, coms_out)


def _inequality_gadget(line, assignments, prover, recorder, index, coms_out):
    left, right = parser.parse_inequality(line)
    left_w = assignments.get_witness(left, None)

    if right.is_witness():
        scalars, _, vars_, _ = assignments.get_witness(right, None)
        right_scalars, right_lcs = scalars, [v.lc() for v in vars_]
    else:
        right_scalars = be_to_scalars(assignments.get_instance(right, None))
        right_lcs = [to_lc(s) for s in right_scalars]

    gadget = Inequality(right_lcs, right_scalars)
    derived_coms, derived_wtns = gadget.setup(prover, left_w[0])
    recorder.commit_drvd(derived_wtns)
    _gprove(gadget, recorder, left_w[2], derived_wtns)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(derived_coms, index, 0, coms_out)


def _set_membership_gadget(line, assignments, prover, recorder, index,
                           coms_out):
    member, set_vars = parser.parse_set_membership(line)

    if member.is_witness():
        member_scalars, _, member_vars, _ = assignments.get_witness(
            member, None)
        member_lcs = [v.lc() for v in member_vars]
    else:
        member_scalars = be_to_scalars(assignments.get_instance(member, None))
        member_lcs = [to_lc(s) for s in member_scalars]

    member_scalar = member_scalars[0]
    member_lc = member_lcs[0]
    apply_hashing = len(member_scalars) > 1

    witness_set_vars, witness_set_scalars = [], []
    instance_set_lcs, instance_set_scalars = [], []

    if not apply_hashing:
        for element in set_vars:
            if element.is_witness():
                scalars, _, vars_, _ = assignments.get_witness(element, None)
                if len(vars_) == 1:
                    witness_set_scalars.append(scalars[0])
                    witness_set_vars.append(vars_[0])
                else:
                    apply_hashing = True
            else:
                scalars = be_to_scalars(
                    assignments.get_instance(element, None))
                if len(scalars) == 1:
                    instance_set_scalars.append(scalars[0])
                    instance_set_lcs.append(to_lc(scalars[0]))
                else:
                    apply_hashing = True

    if apply_hashing:
        hash_number = 1
        if member.is_witness():
            scalar, var = _hash_witness(prover, recorder, member,
                                        assignments, index, hash_number,
                                        coms_out)
            hash_number += 1
            member_scalar, member_lc = scalar, var.lc()
        else:
            member_scalar, member_lc = _hash_instance(member, assignments)

        witness_set_vars, witness_set_scalars = [], []
        instance_set_lcs, instance_set_scalars = [], []

        for element in set_vars:
            if element.is_witness():
                scalar, var = _hash_witness(prover, recorder, element,
                                            assignments, index, hash_number,
                                            coms_out)
                hash_number += 1
                witness_set_vars.append(var)
                witness_set_scalars.append(scalar)
            else:
                scalar, lc = _hash_instance(element, assignments)
                instance_set_lcs.append(lc)
                instance_set_scalars.append(scalar)

    gadget = SetMembership(member_lc, member_scalar, instance_set_lcs,
                           instance_set_scalars)
    derived_coms, derived_wtns = gadget.setup(prover, witness_set_scalars)
    recorder.commit_drvd(derived_wtns)
    _gprove(gadget, recorder, witness_set_vars, derived_wtns)

    assignments.cache_derived_wtns(derived_wtns)
    assignments.parse_derived_witness(derived_coms, index, 0, coms_out)
