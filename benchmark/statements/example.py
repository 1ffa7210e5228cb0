"""example: the upstream README's nine-gadget statement, its values drawn
from the seed at the pinned byte lengths.  The witnesses of one draw differ
in W3 only (W1 and W4 are fixed by the instance's Merkle roots)."""
from reference.models.mimc import mimc_hash, mimc_sponge
from reference.core.scalar import Scalar
from reference.utils.conversions import scalar_to_be


def _value(rng, nbytes):
    return bytes([rng.randrange(1, 256)]) + rng.randbytes(nbytes - 1)


def _lines(pairs):
    return "".join(f"{k} = 0x{v.hex()}\n" for k, v in pairs)


def statement(cfg, w1, w4, i3, i4, i6, w3s):
    """(gadgets, instance, [witness]) of the given values: one witness for
    each W3 in w3s; the roots and W2 are MiMC images of the others."""
    def h(b):
        return mimc_hash(b).v

    def be(v):
        return scalar_to_be(Scalar(v))

    left = mimc_sponge([h(w1), h(i3)])
    right = mimc_sponge([h(i6), h(w4)])
    instance = _lines([
        ("I0", bytes.fromhex(cfg["bounds"]["I0"])),
        ("I1", bytes.fromhex(cfg["bounds"]["I1"])),
        ("I2", be(left)), ("I3", i3), ("I4", i4),
        ("I5", be(mimc_sponge([left, right]))), ("I6", i6),
        ("I7", be(right))])
    witnesses = [_lines([("W0", w1), ("W1", w1), ("W2", be(h(w1))),
                         ("W3", w3), ("W4", w4)]) for w3 in w3s]
    return cfg["gadgets"], instance, witnesses


def draw(rng, cfg, batch):
    """(gadgets, instance, [witness] * batch), `batch` distinct W3s."""
    n = cfg["value_bytes"]
    lo = int(cfg["bounds"]["I0"], 16)
    hi = int(cfg["bounds"]["I1"], 16)
    w1 = rng.randrange(lo, hi + 1).to_bytes(n["W1"], "big")
    w4 = _value(rng, n["W4"])          # one byte, so below W0 >= 0x0100
    i3 = _value(rng, n["I3"])
    i6 = _value(rng, n["I6"])
    i4 = _value(rng, n["I4"])
    w3s = rng.sample([bytes([b]) for b in range(1, 256) if b != i4[0]],
                     batch)
    return statement(cfg, w1, w4, i3, i4, i6, w3s)
