"""Verifier for `.gadgets` statements (reference src/verify.rs, same call
stack), reduced to the scalars of its single multiscalar check, and a batch
check of many proofs on one device (`verify_many`).

Reconstructs the constraint system from the commitments only (None
assignments).  Malformed proofs and commitments verify false.
"""

import hashlib

from ..core.r1cs import Verifier, R1CSError
from ..core.recorder import RecordingCS
from ..core.proof import R1CSProof
from ..core.ristretto import RistrettoPoint, RISTRETTO_BASEPOINT
from ..core.scalar import L
from ..core.transcript import ProofError
from ..core.lc import to_lc
from ..core import curve_torch as ct
from ..utils.merlin import Transcript
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
from . import parser

# what dalek's verify turns into Err, and what a malformed .coms or
# statement raises while the constraint system is rebuilt
REJECTS = (R1CSError, ProofError, KeyError, ValueError, AssertionError)


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


def statement_verifier(name, instance, commitments, gadgets, cache):
    """A Verifier whose transcript has absorbed the commitments, with the
    statement's constraints.  `cache` maps (gadgets, instance, commitment
    names) to the constraints, which depend on nothing else."""
    verifier = Verifier(Transcript(name.encode()))
    assignments = Assignments()
    assignments.parse_instance(instance)
    assignments.parse_commitments(commitments, verifier)
    key = (gadgets, instance, tuple(sorted(assignments.commitments)))
    hit = cache.get(key)
    if hit is not None:
        verifier.constraints, verifier.num_vars = hit
        return verifier
    recorder = RecordingCS(prover_mode=False)
    lines = _peekable(enumerate(gadgets.splitlines()))
    while lines.peek() is not None:
        index, line = lines.next()
        local_initialization = [list(recorder.buffer())]
        _parse_conjunction(lines, line, assignments, recorder,
                           local_initialization)
        _parse_gadget(line, assignments, recorder, index)
    recorder.replay_into(verifier)
    cache[key] = (verifier.constraints, verifier.num_vars)
    return verifier


def _draw(seed: bytes, label: bytes, j: int) -> int:
    return int.from_bytes(hashlib.shake_256(
        seed + label + j.to_bytes(8, "little")).digest(64), "little") % L


def _decompress(encoding):
    point = RistrettoPoint.decompress(encoding)
    if point is None:
        raise ProofError("invalid point encoding")
    return point


def _equation(item, j, seed, cache):
    """(padded_n, table scalars, proof scalars, proof points) of item j,
    or None where it is rejected before the check."""
    name, instance, proof_bytes, commitments, gadgets = item
    try:
        proof = R1CSProof.from_bytes(proof_bytes)
        verifier = statement_verifier(name, instance, commitments, gadgets,
                                      cache)
        padded_n, table, dyn_s, dyn_p = verifier.equation(
            proof, _draw(seed, b"r", j))
        return padded_n, table, dyn_s, [_decompress(b) for b in dyn_p]
    except REJECTS:
        return None


def _holds(k, padded_n, eqs, weights):
    """Whether sum_j weight_j * (check_j) is the identity, on k.device."""
    table = [0] * (2 * padded_n + 2)
    dyn_s, dyn_p = [], []
    for (_, t, s, p), rho in zip(eqs, weights):
        for i, v in enumerate(t):
            table[i] += rho * v
        dyn_s += [rho * v % L for v in s]
        dyn_p += p
    table = [v % L for v in table]
    fixed = [RISTRETTO_BASEPOINT, _blinding_base()] + dyn_p
    G, H = ct.generators(k, padded_n)
    rest = tuple(ct.to_limbs([getattr(q, c) for q in fixed], k.device)
                 for c in "XYZT")
    X, Y, _, _ = ct.msm(k, table + dyn_s, ct.cat_points([G, H, rest]))
    return X % ct.P == 0 or Y % ct.P == 0


def _blinding_base():
    """PedersenGens::default().B_blinding."""
    return RistrettoPoint.from_uniform_bytes(
        hashlib.sha3_512(RISTRETTO_BASEPOINT.compress()).digest())


def verify_many(items, device, seed: bytes):
    """items: [(name, instance, proof bytes, .coms text, gadgets)] ->
    [bool], each what dalek's verify says of it.  The proofs of one
    generator size are checked together, weighted by scalars drawn from
    `seed`; where that check fails, each is checked alone."""
    k = ct.Consts(device)
    cache = {}
    eqs = [_equation(item, j, seed, cache) for j, item in enumerate(items)]
    verdicts = [False] * len(items)
    groups = {}
    for j, eq in enumerate(eqs):
        if eq is not None:
            groups.setdefault(eq[0], []).append(j)
    for padded_n, js in groups.items():
        weights = [_draw(seed, b"rho", j) for j in js]
        if _holds(k, padded_n, [eqs[j] for j in js], weights):
            ok = js
        elif len(js) == 1:
            ok = []
        else:
            ok = [j for j in js if _holds(k, padded_n, [eqs[j]], [1])]
        for j in ok:
            verdicts[j] = True
    return verdicts


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
