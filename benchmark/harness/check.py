"""The comparison that decides `correct`: what the window's requests
returned, held against the plain reference under reference/ (which imports
nothing of the program).  Every number compared is a count of wrong
answers, with the limit 0.

prove_batch cells
  requests_failed    requests that raised or returned another number of
                     proofs than witnesses
  proofs_rejected    of `check_proofs` proofs drawn from the seed, one at
                     least from every slot of the batch, those the
                     reference verifier (dalek's R1CS check, its generators
                     and multiscalar sum computed again on the card) rejects
                     against their .coms and statement
  proofs_repeated    proofs whose bytes another proof of the window has
                     (fresh blindings make every proof new)
  images_wrong       MiMC images in the program's image cache that differ
                     from the reference's MiMCHash-256b of their preimage
verify cells
  requests_failed    requests that raised
  verdicts_wrong     verdicts that differ from the reference's verdict on
                     the same proof
  pool_wrong         set-up proofs the reference does not judge as made:
                     an untampered proof that fails, a tampered one that
                     verifies
"""
import random

LIMITS = {"requests_failed": 0, "proofs_rejected": 0, "proofs_repeated": 0,
          "images_wrong": 0, "verdicts_wrong": 0, "pool_wrong": 0}


def _seed_bytes(seed):
    return str(seed).encode()


def check_prove_batch(traffic, reqs, seed, device, image_cache):
    from reference.lang.verify import verify_many
    from reference.models.mimc import mimc_hash
    from reference.core.scalar import L

    p = traffic.params
    failed = sum(1 for r in reqs if r.error is not None
                 or len(r.out) != len(r.statement[2]))
    proofs = [(r, slot, proof, coms) for r in reqs if r.error is None
              for slot, (proof, _, coms) in enumerate(r.out)]
    repeated = len(proofs) - len({proof for _, _, proof, _ in proofs})
    sample = sample_proofs(proofs, p["check_proofs"],
                           random.Random(f"check/{seed}"))
    items = [(traffic.name, r.statement[1], proof, coms, r.statement[0])
             for r, _, proof, coms in (proofs[i] for i in sample)]
    verdicts = verify_many(items, device, _seed_bytes(seed))
    wrong_images = sum(1 for data, image in list(image_cache.items())
                       if mimc_hash(data).v != image.v % L)
    return {"requests_failed": failed,
            "proofs_rejected": verdicts.count(False),
            "proofs_repeated": repeated,
            "images_wrong": wrong_images}, {
                "proofs_checked": len(items),
                "images_checked": len(image_cache)}


def sample_proofs(proofs, n, rnd):
    """Indices into `proofs` ([(request, slot, ...)]) of the proofs to
    verify: one drawn at every slot of the batch, so that a fault confined
    to one slot is always met, then draws from the rest up to `n`."""
    by_slot = {}
    for i, (_, slot, *_rest) in enumerate(proofs):
        by_slot.setdefault(slot, []).append(i)
    picked = [rnd.choice(by_slot[slot]) for slot in sorted(by_slot)]
    chosen = set(picked)
    rest = [i for i in range(len(proofs)) if i not in chosen]
    return picked + rnd.sample(rest, max(0, min(n - len(picked), len(rest))))


def check_verify(traffic, reqs, seed, device):
    from reference.lang.verify import verify_many

    gadgets, instance, _ = traffic.fixed
    truth = [None] * len(traffic.pool)
    # the untampered proofs in one batch check, each tampered one alone
    groups = [[i for i, (_, _, v) in enumerate(traffic.pool) if v]]
    groups += [[i] for i, (_, _, v) in enumerate(traffic.pool) if not v]
    for group in groups:
        items = [(traffic.name, instance) + traffic.pool[i][:2] + (gadgets,)
                 for i in group]
        for i, t in zip(group, verify_many(items, device,
                                           _seed_bytes(seed))):
            truth[i] = t
    pool_wrong = sum(1 for t, (_, _, valid) in zip(truth, traffic.pool)
                     if t != valid)
    failed = sum(1 for r in reqs if r.error is not None)
    wrong = sum(1 for r in reqs if r.error is None
                and r.out != truth[r.index % len(truth)])
    return {"requests_failed": failed, "verdicts_wrong": wrong,
            "pool_wrong": pool_wrong}, {"verifies_checked": len(reqs)}


def judge(numbers):
    """(correct, {name: {"value", "limit"}})."""
    table = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
