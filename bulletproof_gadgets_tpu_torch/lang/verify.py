"""Verifier orchestrator for `.gadgets` statements
(reference src/verify.rs — same call stack, SURVEY.md §3.2).

Reconstructs the identical constraint system from commitments only (None
assignments) and checks the proof with the single mega-MSM.  Malformed
proofs return False rather than raising (verify.rs:71-72).
"""

from ..core.gens import PedersenGens, BulletproofGens
from ..core.r1cs import Verifier, R1CSError
from ..core.recorder import RecordingCS
from ..core.proof import R1CSProof
from ..core.transcript import ProofError
from ..core.lc import to_lc
from ..utils.merlin import new_transcript as Transcript
from ..utils.conversions import be_to_scalar, be_to_scalars
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
from .assignments import Assignments, assert_32
from .prove import round_pow2, _peekable
from . import parser
from . import template


def verify(name: str, instance: str, proof_bytes: bytes, commitments: str,
           gadgets: str) -> bool:
    """Mirrors verify() at src/verify.rs:36-73."""
    try:
        transcript = Transcript(name.encode())
        pc_gens = PedersenGens.default()
        verifier = Verifier(transcript)
        recorder = RecordingCS(prover_mode=False)

        proof = R1CSProof.from_bytes(proof_bytes)
        assignments = Assignments()
        assignments.parse_instance(instance)
        assignments.parse_commitments(commitments, verifier)

        # verifier-side template cache: the reconstructed constraint
        # system is a pure function of (gadgets, instance, commitment-key
        # structure) — on a hit the whole gadget loop is skipped
        cache_key = None
        tmpl = None
        if template.enabled():
            cache_key = (gadgets, instance,
                         template.commitment_shape(commitments))
            tmpl = template.verifier_cache.get(cache_key)

        if tmpl is not None:
            tmpl.apply(verifier)
        else:
            lines = _peekable(enumerate(gadgets.splitlines()))
            while lines.peek() is not None:
                index, line = lines.next()
                local_initialization = [list(recorder.buffer())]
                _parse_conjunction(lines, line, assignments, recorder,
                                   local_initialization)
                _parse_gadget(line, assignments, recorder, index)

            recorder.replay_into(verifier)
            if cache_key is not None:
                template.verifier_cache.put(
                    cache_key, template.VerifierTemplate(
                        verifier.constraints, verifier.num_vars))

        bp_gens = BulletproofGens(round_pow2(verifier.get_num_vars()), 1)
        verifier.verify(proof, pc_gens, bp_gens)
        return True
    except (R1CSError, ProofError):
        return False


def _parse_gadget(line, assignments, recorder, index):
    op = get_gadget_op(line)
    if op == BOUND:
        _bounds_check_gadget(line, assignments, recorder, index)
    elif op == HASH:
        _mimc_hash_gadget(line, assignments, recorder, index)
    elif op == MERKLE:
        _merkle_tree_gadget(line, assignments, recorder, index)
    elif op == EQUALS:
        _equality_gadget(line, assignments, recorder)
    elif op == LESS_THAN:
        _less_than_gadget(line, assignments, recorder, index)
    elif op == UNEQUAL:
        _inequality_gadget(line, assignments, recorder, index)
    elif op == SET_MEMBER:
        _set_membership_gadget(line, assignments, recorder, index)


def _parse_conjunction(lines, line, assignments, recorder, initialization):
    if get_gadget_op(line) == OR:
        _or_conjunction(lines, assignments, recorder, initialization)


def _or_conjunction(lines, assignments, parent_recorder, initialization):
    recorder = RecordingCS(prover_mode=False)
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
            _parse_conjunction(lines, line, assignments, recorder,
                               local_initialization)
            _parse_gadget(line, assignments, recorder, local_index)

    or_gadget(parent_recorder, recorder)


def _hash_witness(recorder, var, index, subroutine, assignments):
    """verify.rs:397-415."""
    preimage = assignments.get_all_commitments(var)
    image = assignments.get_derived(index, 0, subroutine)

    derived1 = assignments.get_derived(index, 1, subroutine)
    derived2 = assignments.inquire_derived(index, 2, subroutine)
    derived = [derived1, derived2] if derived2 is not None else [derived1]

    gadget = MimcHash256(image.lc())
    gadget.verify(recorder, preimage, derived)
    return image


def _hash_instance(var, assignments):
    return to_lc(mimc_hash(assignments.get_instance(var, None)))


def _bounds_check_gadget(line, assignments, recorder, index):
    var, mn, mx = parser.parse_bound(line)
    v = assignments.get_commitment(var, 0)
    mn_b = assignments.get_instance(mn, assert_32)
    mx_b = assignments.get_instance(mx, assert_32)
    a = assignments.get_derived(index, 0, 0)
    b = assignments.get_derived(index, 1, 0)
    gadget = BoundsCheck(mn_b, mx_b)
    gadget.verify(recorder, [v], [a, b])


def _mimc_hash_gadget(line, assignments, recorder, index):
    image, preimage = parser.parse_hash(line)
    if image.is_witness():
        image_lc = assignments.get_commitment(image, 0).lc()
    else:
        image_lc = to_lc(be_to_scalar(
            assignments.get_instance(image, assert_32)))

    preimage_vars = assignments.get_all_commitments(preimage)
    derived1 = assignments.get_derived(index, 0, 0)
    derived2 = assignments.inquire_derived(index, 1, 0)
    derived = [derived1, derived2] if derived2 is not None else [derived1]

    gadget = MimcHash256(image_lc)
    gadget.verify(recorder, preimage_vars, derived)


def _merkle_tree_gadget(line, assignments, recorder, index):
    root, instance_vars, witness_vars, pattern = parser.parse_merkle(line)
    if root.is_witness():
        root_lc = assignments.get_commitment(root, 0).lc()
    else:
        root_lc = to_lc(be_to_scalar(
            assignments.get_instance(root, assert_32)))

    instance_lcs = [_hash_instance(v, assignments) for v in instance_vars]
    witness_lcs = []
    for hash_number, wvar in enumerate(witness_vars):
        image_var = _hash_witness(recorder, wvar, index, hash_number,
                                  assignments)
        witness_lcs.append(image_var.lc())

    gadget = MerkleTree256(root_lc, instance_lcs, witness_lcs, pattern)
    gadget.verify(recorder, [], [])


def _equality_gadget(line, assignments, recorder):
    left, right = parser.parse_equality(line)
    left_vars = assignments.get_all_commitments(left)
    if right.is_witness():
        right_lcs = [v.lc() for v in assignments.get_all_commitments(right)]
    else:
        right_lcs = [to_lc(s) for s in be_to_scalars(
            assignments.get_instance(right, None))]
    gadget = Equality(right_lcs)
    gadget.verify(recorder, left_vars, [])


def _less_than_gadget(line, assignments, recorder, index):
    left, right = parser.parse_less_than(line)
    left_v = assignments.get_commitment(left, 0)
    right_v = assignments.get_commitment(right, 0)
    delta = assignments.get_derived(index, 0, 0)
    delta_inv = assignments.get_derived(index, 1, 0)
    gadget = LessThan(left_v.lc(), None, right_v.lc(), None)
    gadget.verify(recorder, [], [delta, delta_inv])


def _inequality_gadget(line, assignments, recorder, index):
    left, right = parser.parse_inequality(line)
    left_vars = assignments.get_all_commitments(left)
    if right.is_witness():
        right_lcs = [v.lc() for v in assignments.get_all_commitments(right)]
    else:
        right_lcs = [to_lc(s) for s in be_to_scalars(
            assignments.get_instance(right, None))]

    derived = []
    for i in range(len(left_vars) * 2):
        derived.append(assignments.get_derived(index, i, 0))
    derived.append(assignments.get_derived(index, len(left_vars) * 2, 0))

    gadget = Inequality(right_lcs, None)
    gadget.verify(recorder, left_vars, derived)


def _set_membership_gadget(line, assignments, recorder, index):
    member, set_vars = parser.parse_set_membership(line)

    if member.is_witness():
        member_lcs = [v.lc() for v in assignments.get_all_commitments(member)]
    else:
        member_lcs = [to_lc(s) for s in be_to_scalars(
            assignments.get_instance(member, None))]

    member_lc = member_lcs[0]
    apply_hashing = False

    witness_set_vars = []
    instance_set_lcs = []
    derived = []

    for element in set_vars:
        if element.is_witness():
            witness = assignments.get_all_commitments(element)
            if len(witness) == 1:
                witness_set_vars.append(witness[0])
            else:
                apply_hashing = True
        else:
            lcs = be_to_scalars(assignments.get_instance(element, None))
            if len(lcs) == 1:
                instance_set_lcs.append(to_lc(lcs[0]))
            else:
                apply_hashing = True

    if len(member_lcs) > 1:
        apply_hashing = True

    # one-hot selector commitments
    for pointer in range(len(set_vars)):
        derived.append(assignments.get_derived(index, pointer, 0))

    if apply_hashing:
        hash_number = 1
        if member.is_witness():
            image_var = _hash_witness(recorder, member, index, hash_number,
                                      assignments)
            hash_number += 1
            member_lc = image_var.lc()
        else:
            member_lc = _hash_instance(member, assignments)

        witness_set_vars = []
        instance_set_lcs = []
        for element in set_vars:
            if element.is_witness():
                image_var = _hash_witness(recorder, element, index,
                                          hash_number, assignments)
                hash_number += 1
                witness_set_vars.append(image_var)
            else:
                instance_set_lcs.append(_hash_instance(element, assignments))

    gadget = SetMembership(member_lc, None, instance_set_lcs, None)
    gadget.verify(recorder, witness_set_vars, derived)
