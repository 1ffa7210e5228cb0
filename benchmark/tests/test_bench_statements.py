"""The statement generators' instances and witnesses satisfy their
statements, checked with the benchmark's own MiMC; at the repository's
pinned values they reproduce the pinned statements and roots."""
import json
import os
import random

import pytest

from harness import spec
from reference.lang.parser import parse_assignment
from reference.models.mimc import mimc_hash, mimc_sponge
from reference.utils.conversions import be_to_scalar

with open(os.path.join(spec.ROOT, "tests", "port_pins.json")) as f:
    PINS = json.load(f)["statements"]


def _values(text):
    return dict(parse_assignment(line) for line in text.splitlines()
                if line.strip())


def _cfg(name):
    with open(os.path.join(spec.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _module(name):
    return spec.load_module(os.path.join(spec.BENCH, "statements",
                                         name + ".py"), "st_" + name)


def test_example_pin():
    pin = PINS["example"]
    w, i = _values(pin["witness"]), _values(pin["instance"])
    gadgets, instance, witnesses = _module("example").statement(
        _cfg("example"), w["W1"], w["W4"], i["I3"], i["I4"], i["I6"],
        [w["W3"]])
    assert gadgets == pin["gadgets"]
    assert instance == pin["instance"]
    assert witnesses == [pin["witness"]]


def test_merkle32_pin():
    pin = PINS["merkle32"]
    values = {**_values(pin["witness"]), **_values(pin["instance"])}
    gadgets, instance, witnesses = _module("merkle32").statement(
        _cfg("merkle32"), values, 2)
    assert gadgets == pin["gadgets"]
    assert instance == pin["instance"]
    assert witnesses == [pin["witness"]] * 2


def _h(b):
    return mimc_hash(b).v


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_example_draws_satisfy(seed):
    cfg = _cfg("example")
    gadgets, instance, witnesses = _module("example").draw(
        random.Random(seed), cfg, 8)
    i = _values(instance)
    ws = [_values(w) for w in witnesses]
    assert len({w["W3"] for w in ws}) == 8
    lengths = {k: len(v) for k, v in
               {**_values(PINS["example"]["instance"]),
                **_values(PINS["example"]["witness"])}.items()}
    for w in ws:
        for k, v in {**i, **w}.items():
            assert len(v) == lengths[k], k
        for k in ("W1", "W3", "W4", "I3", "I4", "I6"):
            assert {**i, **w}[k][0] != 0, k
        w1 = int.from_bytes(w["W1"], "big")
        assert w["W0"] == w["W1"]
        assert int.from_bytes(i["I0"], "big") <= w1 <= int.from_bytes(
            i["I1"], "big")
        assert be_to_scalar(w["W2"]).v == _h(w["W1"])
        left = mimc_sponge([_h(w["W1"]), _h(i["I3"])])
        right = mimc_sponge([_h(i["I6"]), _h(w["W4"])])
        assert be_to_scalar(i["I2"]).v == left
        assert be_to_scalar(i["I7"]).v == right
        assert be_to_scalar(i["I5"]).v == mimc_sponge([left, right])
        assert w["W3"] != i["I4"]
        assert w["W0"] in (i["I0"], i["I1"], w["W1"], i["I7"])
        assert int.from_bytes(w["W4"], "big") < w1


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_merkle32_draws_satisfy(seed):
    cfg = _cfg("merkle32")
    gadgets, instance, witnesses = _module("merkle32").draw(
        random.Random(seed), cfg, 4)
    assert gadgets == PINS["merkle32"]["gadgets"]
    i = _values(instance)
    w = _values(witnesses[0])
    assert len(set(witnesses)) == 1 and len(witnesses) == 4
    leaves = [w["W0"]] + [i[f"I{k}"] for k in range(1, 32)]
    assert len(w["W0"]) == 2 and all(len(v) == 3 for v in leaves[1:])
    level = [_h(v) for v in leaves]
    while len(level) > 1:
        level = [mimc_sponge([level[k], level[k + 1]])
                 for k in range(0, len(level), 2)]
    assert be_to_scalar(i["I0"]).v == level[0]


def test_draws_follow_the_seed():
    cfg = _cfg("example")
    a = _module("example").draw(random.Random(5), cfg, 8)
    b = _module("example").draw(random.Random(5), cfg, 8)
    c = _module("example").draw(random.Random(6), cfg, 8)
    assert a == b and a != c
