"""Parsers for the .gadgets mini-language and the variable-assignment files
(.inst / .wtns / .coms).

Replaces the reference's two LALRPOP grammars
(src/lalrpop/gadget_grammar.lalrpop, var_grammar.lalrpop) with
recursive-descent over the same token language:
  gadget lines:  HASH/BOUND/LESS_THAN/EQUALS/UNEQUAL/SET_MEMBER/MERKLE with
                 I\\d+ / W\\d+ variables and nested ( ) Merkle tree patterns
  var lines:     <name> = 0x<hex>, names I\\d+ | W\\d+ | [CD]\\d+-\\d+(-\\d+)?
"""
import re

from .ast import Var
from ..models.merkle_tree import Hash, W as PW, I as PI

_VAR_RE = re.compile(r"^[IW]\d+$")
_ASSIGN_RE = re.compile(
    r"^\s*(?P<name>[IW]\d+|[CD]\d+-\d+(?:-\d+)?)\s*=\s*"
    r"0[xX](?P<hex>[0-9a-fA-F]+)\s*$")


class ParseError(ValueError):
    pass


def _tokenize(line: str):
    # make parens standalone tokens
    return line.replace("(", " ( ").replace(")", " ) ").split()


def _var(token: str) -> Var:
    if not _VAR_RE.match(token):
        raise ParseError(f"expected variable, got {token!r}")
    return Var(token[0], token)


def _expect_witness(v: Var, line):
    if not v.is_witness():
        raise ParseError(f"expected witness variable in {line!r}")
    return v


def _expect_instance(v: Var, line):
    if not v.is_instance():
        raise ParseError(f"expected instance variable in {line!r}")
    return v


def parse_hash(line: str):
    """HASH <image: W|I> <preimage: W> -> (image, preimage)"""
    toks = _tokenize(line)
    if len(toks) != 3 or toks[0] != "HASH":
        raise ParseError(f"bad HASH line: {line!r}")
    image = _var(toks[1])
    preimage = _expect_witness(_var(toks[2]), line)
    return image, preimage


def parse_bound(line: str):
    toks = _tokenize(line)
    if len(toks) != 4 or toks[0] != "BOUND":
        raise ParseError(f"bad BOUND line: {line!r}")
    var = _expect_witness(_var(toks[1]), line)
    mn = _expect_instance(_var(toks[2]), line)
    mx = _expect_instance(_var(toks[3]), line)
    return var, mn, mx


def parse_less_than(line: str):
    toks = _tokenize(line)
    if len(toks) != 3 or toks[0] != "LESS_THAN":
        raise ParseError(f"bad LESS_THAN line: {line!r}")
    return (_expect_witness(_var(toks[1]), line),
            _expect_witness(_var(toks[2]), line))


def _parse_symmetric(line: str, op: str):
    """EQUALS/UNEQUAL: (W, I) | (I, W) -> normalized (witness, instance);
    (W, W) stays as-is (gadget_grammar.lalrpop:19-29)."""
    toks = _tokenize(line)
    if len(toks) != 3 or toks[0] != op:
        raise ParseError(f"bad {op} line: {line!r}")
    a, b = _var(toks[1]), _var(toks[2])
    if a.is_witness():
        return a, b
    if b.is_witness():
        return b, a
    raise ParseError(f"{op} requires at least one witness: {line!r}")


def parse_equality(line: str):
    return _parse_symmetric(line, "EQUALS")


def parse_inequality(line: str):
    return _parse_symmetric(line, "UNEQUAL")


def parse_set_membership(line: str):
    toks = _tokenize(line)
    if len(toks) < 3 or toks[0] != "SET_MEMBER":
        raise ParseError(f"bad SET_MEMBER line: {line!r}")
    member = _var(toks[1])
    members = [_var(t) for t in toks[2:]]
    return member, members


def parse_merkle(line: str):
    """MERKLE <root: W|I> <tree> -> (root, instance_vars, witness_vars,
    pattern).  The tree grammar collects leaves left-to-right into separate
    instance/witness queues (gadget_grammar.lalrpop:46-72)."""
    toks = _tokenize(line)
    if len(toks) < 2 or toks[0] != "MERKLE":
        raise ParseError(f"bad MERKLE line: {line!r}")
    root = _var(toks[1])
    pos = 2

    def parse_tree():
        nonlocal pos
        if pos >= len(toks) or toks[pos] != "(":
            raise ParseError(f"expected '(' in MERKLE tree: {line!r}")
        pos += 1
        elems = []
        for _ in range(2):
            if pos >= len(toks):
                raise ParseError(f"truncated MERKLE tree: {line!r}")
            if toks[pos] == "(":
                elems.append(parse_tree())
            else:
                elems.append(_var(toks[pos]))
                pos += 1
        if pos >= len(toks) or toks[pos] != ")":
            raise ParseError(f"expected ')' in MERKLE tree: {line!r}")
        pos += 1
        inst, wtns, patterns = [], [], []
        for e in elems:
            if isinstance(e, tuple):
                i2, w2, p2 = e
                inst.extend(i2)
                wtns.extend(w2)
                patterns.append(p2)
            elif e.is_witness():
                wtns.append(e)
                patterns.append(PW)
            else:
                inst.append(e)
                patterns.append(PI)
        return inst, wtns, Hash(patterns[0], patterns[1])

    inst, wtns, pattern = parse_tree()
    if pos != len(toks):
        raise ParseError(f"trailing tokens in MERKLE line: {line!r}")
    return root, inst, wtns, pattern


def parse_assignment(line: str):
    """One `.inst`/`.wtns`/`.coms` line -> (name, bytes)."""
    m = _ASSIGN_RE.match(line)
    if not m:
        raise ParseError(f"bad assignment line: {line!r}")
    h = m.group("hex")
    if len(h) % 2:
        h = "0" + h
    return m.group("name"), bytes.fromhex(h)
