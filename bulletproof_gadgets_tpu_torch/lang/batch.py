"""Batched-witness proving: one `.gadgets` circuit over many witness sets
(the data-parallel axis), the port of the JAX package's lang/batch.py.

The reference proves one statement at a time (bin/prover.rs); a prover
service proves the same circuit over many witnesses.  Each proof keeps its
own Fiat-Shamir transcript, but across a batch the device work combines:

  * every MiMC witness/instance image of the batch is hashed once by the
    device sponge (ops/mimc_kernels.mimc_hash_batch), seeding
    models.mimc's image cache before any proof starts;
  * the proofs' generators (core/r1cs.Prover.prove_gen) run in lockstep:
    the A_I/A_O/S commitments of proofs sharing a table (ops/engine caches
    one table per circuit size) go into one encoded MSM of up to
    max_stack_k() stacked vectors (its points compressed on the device,
    one readback of their bytes), the t-poly readbacks into one transfer,
    and the arguments into one ops/ipa_fused.create_batched per table.

A batch's bytes are not those of sequential proves: every witness is
prepared (its commitments' blindings drawn) before any proof starts, and on
a device table the lockstep draws every proof's commitment blindings before
any proof's t-poly blindings.  They equal the JAX package's prove_batch on
the same kind of table under the same seed.

API mirrors lang.prove/lang.verify per element:
  prove_batch(name, instance, [witness...], gadgets)
      -> [(proof_bytes, num_constraints, coms_str), ...]
  verify_batch(name, instance, [(proof, coms)...], gadgets) -> [bool, ...]
"""
import torch

from ..models import mimc
from ..ops import engine
from .assignments import parse_assignment
from .prove import prove_prepared
from .verify import verify


def _witness_values(witness: str):
    for line in witness.splitlines():
        if line.strip():
            yield parse_assignment(line)[1]


def warm_image_cache(byte_values, device) -> int:
    """Hash every byte string on `device` and seed models.mimc._image_cache.
    Returns the number of images computed."""
    from ..ops.mimc_kernels import mimc_hash_batch

    todo = [b for b in dict.fromkeys(byte_values)
            if b not in mimc._image_cache]
    if not todo:
        return 0
    for data, image in zip(todo, mimc_hash_batch(todo, device)):
        mimc._image_cache[data] = image
    return len(todo)


def _max_launch_k():
    """Stacked vectors per combined MSM launch (ops/msm_serial)."""
    from ..ops.msm_serial import max_stack_k
    return max_stack_k()


def _groups(items, k_cap):
    """Split [(i, digits)] into runs of at most k_cap stacked vectors (a
    run always takes at least one request)."""
    groups, ks = [[]], 0
    for i, dig in items:
        k = dig.shape[0] // 32
        if ks + k > k_cap and groups[-1]:
            groups.append([])
            ks = 0
        groups[-1].append((i, dig, k))
        ks += k
    return groups


def _drive_lockstep(gens, max_k=None):
    """Run prover generators in lockstep, answering each step's requests
    together: same-table "msm_enc" requests as one encoded MSM per <= max_k
    (default max_stack_k()) stacked vectors, all launched before the first
    readback (each reads its encodings and its pool check in one), "fetch" requests as one transfer per shape, "fused_ipa"
    requests as one create_batched per table.  A generator that yields
    nothing (a host table) finishes at its first step."""
    live = dict(enumerate(gens))
    resps = {i: None for i in live}
    results = {}
    k_cap = max_k or _max_launch_k()
    while live:
        msms, fetches, ipas = {}, {}, {}
        for i in list(live):
            try:
                kind, table, arg = live[i].send(resps[i])
            except StopIteration as stop:
                results[i] = stop.value
                del live[i]
                continue
            if kind == "msm_enc":
                msms.setdefault(id(table), (table, []))[1].append((i, arg))
            elif kind == "fetch":
                fetches.setdefault(tuple(arg.shape), []).append((i, arg))
            else:
                assert kind == "fused_ipa"
                ipas.setdefault(id(table), (table, []))[1].append((i, arg))
        pending = [(table, group, table.msm_digits_enc_launch(
            torch.cat([d for _, d, _ in group])))
            for table, items in msms.values()
            for group in _groups(items, k_cap)]
        for table, group, launch in pending:
            encs = table.msm_digits_enc_finish(launch)
            off = 0
            for i, _, k in group:
                resps[i] = encs[off:off + k]
                off += k
        for items in fetches.values():
            rows = torch.stack([a for _, a in items]).cpu()
            for (i, _), row in zip(items, rows):
                resps[i] = row
        if ipas:
            from ..ops import ipa_fused
            for table, items in ipas.values():
                cols = list(zip(*(args for _, args in items)))
                outs = ipa_fused.create_batched(cols[0], table, *cols[1:])
                for (i, _), out in zip(items, outs):
                    resps[i] = out
    return [results[i] for i in range(len(gens))]


def prove_batch(name, instance, witnesses, gadgets, device=None,
                max_k=None):
    """Prove one circuit over a batch of witness sets -> [(proof_bytes,
    num_constraints, coms_str)] in witness order.  The device work runs on
    `device`, else on the device registered before (ops/engine), else on
    CUDA, which raises where CUDA is missing.  `max_k` caps the stacked
    vectors per commitment launch below max_stack_k() (max_k=3: one
    proof's commitments per launch)."""
    dev = engine.use(device)
    if any(op in gadgets for op in ("HASH", "MERKLE", "SET_MEMBER")):
        values = [v for w in witnesses for v in _witness_values(w)]
        values += list(_witness_values(instance))
        warm_image_cache(values, dev)

    prepared = []
    for w in witnesses:
        coms = []
        prover, bp_gens, nc = prove_prepared(name, instance, w, gadgets,
                                             coms, dev)
        prepared.append((prover, bp_gens, nc, coms))

    proofs = _drive_lockstep(
        [prover.prove_gen(bp_gens) for prover, bp_gens, _, _ in prepared],
        max_k)
    return [(proof.to_bytes(), nc, "".join(coms))
            for proof, (_, _, nc, coms) in zip(proofs, prepared)]


def verify_batch(name, instance, proofs_and_coms, gadgets, device=None):
    """[(proof_bytes, coms_str)] -> [bool] in order (lang.verify.verify
    each, on `device` as in prove_batch)."""
    return [verify(name, instance, proof, coms, gadgets, device=device)
            for proof, coms in proofs_and_coms]
