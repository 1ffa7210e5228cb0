"""merkle32: one witness leaf W0 among `leaves` leaves of a MiMC Merkle tree
whose root is the instance's I0 (the upstream merkle_tree_gadget's
statement, cut to 32 leaves)."""
from reference.models.mimc import mimc_hash, mimc_sponge
from reference.core.scalar import Scalar
from reference.utils.conversions import scalar_to_be


def _value(rng, nbytes):
    return bytes([rng.randrange(1, 256)]) + rng.randbytes(nbytes - 1)


def _tree(names, values):
    """(pattern text, root) of a balanced tree over the named leaves."""
    if len(names) == 1:
        return names[0], mimc_hash(values[names[0]]).v
    half = len(names) // 2
    (lt, lv), (rt, rv) = (_tree(names[:half], values),
                          _tree(names[half:], values))
    return f"({lt} {rt})", mimc_sponge([lv, rv])


def _lines(pairs):
    return "".join(f"{k} = 0x{v.hex()}\n" for k, v in pairs)


def statement(cfg, values, batch):
    """(gadgets, instance, [witness] * batch) of the leaf values {name:
    bytes}: W0 and I1 .. I{leaves - 1}."""
    names = ["W0"] + [f"I{i}" for i in range(1, cfg["leaves"])]
    text, root = _tree(names, values)
    instance = _lines([("I0", scalar_to_be(Scalar(root)))]
                      + [(n, values[n]) for n in names[1:]])
    return (f"MERKLE I0 {text}\n", instance,
            [_lines([("W0", values["W0"])])] * batch)


def draw(rng, cfg, batch):
    """statement() of leaves drawn from rng: the batch proves one leaf
    (fresh blindings for each proof)."""
    values = {"W0": _value(rng, cfg["witness_leaf_bytes"])}
    values.update({f"I{i}": _value(rng, cfg["instance_leaf_bytes"])
                   for i in range(1, cfg["leaves"])})
    return statement(cfg, values, batch)
