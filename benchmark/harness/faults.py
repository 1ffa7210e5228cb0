"""Faults planted under the timed path, each the kind of break `correct`
has to catch (benchmark/control.py runs them on the card, tests/ on the
CPU).  Each wraps the Port's entries; the traffic calls them unchanged.

  tamper   a proof altered where it is produced (t_x's first byte flipped)
  tamper_slot  the same, in the batch's last slot only
  repeat   a step that returns its state unchanged: every request after
           the first gets the first request's proofs again
  half     half of the batch left out: half the proofs come back
  mimc485  the control of prove cells: the batch's MiMC images from a
           sponge one round short (a cheaper hash, breaking the
           configuration's "every image is MiMCHash-256b's")
  accept   the control of verify cells: a verifier that skips its final
           multiscalar check and accepts every proof that parses
"""
from .traffic import tamper

PROVE_CONTROL = ("mimc485",)
VERIFY_CONTROL = ("accept",)


def plant(name, port):
    if name == "tamper":
        orig = port.prove_batch

        def prove_batch(*args, **kwargs):
            return [(tamper(p), n, c) for p, n, c in orig(*args, **kwargs)]
        port.prove_batch = prove_batch
    elif name == "tamper_slot":
        orig = port.prove_batch

        def prove_batch(*args, **kwargs):
            out = orig(*args, **kwargs)
            proof, n, c = out[-1]
            return out[:-1] + [(tamper(proof), n, c)]
        port.prove_batch = prove_batch
    elif name == "repeat":
        orig, first = port.prove_batch, []

        def prove_batch(*args, **kwargs):
            if not first:
                first.append(orig(*args, **kwargs))
            return first[0]
        port.prove_batch = prove_batch
    elif name == "half":
        orig = port.prove_batch

        def prove_batch(*args, **kwargs):
            out = orig(*args, **kwargs)
            return out[:len(out) // 2]
        port.prove_batch = prove_batch
    elif name == "mimc485":
        _plant_short_sponge(port)
    elif name == "accept":
        def verify(name_, instance, proof, coms, gadgets, device=None):
            return True
        port.verify = verify
    else:
        raise ValueError(f"unknown fault {name!r}")


def _plant_short_sponge(port):
    """The port's image cache, once its batch sponge has run, holds the
    485-round images of the values it hashed."""
    from reference.models import mimc as ref_mimc

    batch = port.batch_module
    orig = batch.warm_image_cache
    cache = port.image_cache

    def short(data):
        scalars = ref_mimc.pad_preimage(ref_mimc.be_to_scalars(data))
        state = 0
        for block in scalars:
            state = (state + block.v) % ref_mimc.L
            state = ref_mimc.mimc_encryption(
                state, 0, ref_mimc.ROUND_CONSTANTS[:-1])
        return state

    def warm_image_cache(values, device):
        new = [v for v in dict.fromkeys(values) if v not in cache]
        n = orig(values, device)
        for v in new:
            if v in cache:
                cache[v] = type(cache[v])(short(v))
        return n
    batch.warm_image_cache = warm_image_cache
    port.restore.append((batch, "warm_image_cache", orig))
