"""xdrquery: a small filter language over decoded XDR values
(ref src/util/xdrquery/ — the reference's flex/bison grammar collapses to
a recursive-descent parser over the same surface: dotted field paths,
comparisons, && / || / !, parentheses, int/string literals).

Used for operator-side inspection (`dumpxdr`-style filtering of ledger
entries, e.g. ``data.account.balance > 1000000000``).  Paths traverse
namedtuple fields; union arms deref by arm name (``data.account`` selects
the ACCOUNT arm's value and fails the row when the union holds another
arm); ``.type`` reads a union discriminant; 32-byte values compare against
hex strings.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+)
    | (?P<str>'[^']*'|"[^"]*")
    | (?P<op>&&|\|\||==|!=|<=|>=|<|>|!|\(|\))
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z0-9_]+)*)
    )""", re.VERBOSE)


class QueryError(Exception):
    pass


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = TOKEN_RE.match(src, pos)
        if m is None or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise QueryError(f"bad token at {src[pos:pos + 12]!r}")
        pos = m.end()
        for kind in ("num", "str", "op", "name"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    return out


class _Missing:
    """Path didn't resolve (wrong union arm / absent option): the row
    fails every comparison, like the reference's NULL semantics."""


MISSING = _Missing()


def resolve_path(value: Any, path: str) -> Any:
    for part in path.split("."):
        if value is MISSING or value is None:
            return MISSING
        if part == "type" and hasattr(value, "type"):
            value = value.type
            continue
        if hasattr(value, part):
            value = getattr(value, part)
            continue
        # union arm deref: .value carries the arm; arm name must match
        # the declared arm for the current discriminant
        inner = getattr(value, "value", MISSING)
        if inner is not MISSING and hasattr(inner, part):
            value = getattr(inner, part)
            continue
        if inner is not MISSING and _arm_matches(value, part):
            value = inner
            continue
        return MISSING
    return value


def _arm_matches(union_val, name: str) -> bool:
    """Does the union currently hold the arm called ``name``?
    (_UnionValue carries its arm name; matched case-insensitively so
    ``data.account.balance`` selects the ACCOUNT arm.)"""
    arm = getattr(union_val, "arm", None)
    return arm is not None and arm.lower() == name.lower()


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise QueryError("unexpected end of query")
        self.i += 1
        return t

    def parse(self):
        node = self.parse_or()
        if self.peek() is not None:
            raise QueryError(f"trailing tokens: {self.toks[self.i:]}")
        return node

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("op", "||"):
            self.take()
            right = self.parse_and()
            left = ("or", left, right)
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.peek() == ("op", "&&"):
            self.take()
            right = self.parse_not()
            left = ("and", left, right)
        return left

    def parse_not(self):
        if self.peek() == ("op", "!"):
            self.take()
            return ("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_atom()
        t = self.peek()
        if t is not None and t[0] == "op" and t[1] in (
                "==", "!=", "<", "<=", ">", ">="):
            self.take()
            right = self.parse_atom()
            return ("cmp", t[1], left, right)
        return left

    def parse_atom(self):
        t = self.take()
        if t == ("op", "("):
            node = self.parse_or()
            if self.take() != ("op", ")"):
                raise QueryError("expected )")
            return node
        kind, v = t
        if kind == "num":
            return ("lit", int(v))
        if kind == "str":
            return ("lit", v[1:-1])
        if kind == "name":
            if v in ("true", "false"):
                return ("lit", v == "true")
            return ("path", v)
        raise QueryError(f"unexpected token {t}")


def compile_query(src: str):
    """Compile to a predicate over decoded XDR values."""
    ast = _Parser(_tokenize(src)).parse()

    def truthy(x) -> bool:
        # an unresolved path is NULL-ish: false in any boolean context
        return x is not MISSING and bool(x)

    def evaluate(node, value):
        kind = node[0]
        if kind == "lit":
            return node[1]
        if kind == "path":
            return resolve_path(value, node[1])
        if kind == "and":
            return truthy(evaluate(node[1], value)) and \
                truthy(evaluate(node[2], value))
        if kind == "or":
            return truthy(evaluate(node[1], value)) or \
                truthy(evaluate(node[2], value))
        if kind == "not":
            return not truthy(evaluate(node[1], value))
        if kind == "cmp":
            _, op, ln, rn = node
            lv = evaluate(ln, value)
            rv = evaluate(rn, value)
            if lv is MISSING or rv is MISSING:
                return False
            lv, rv = _coerce(lv, rv)
            if op == "==":
                return lv == rv
            if op == "!=":
                return lv != rv
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            if op == ">=":
                return lv >= rv
        raise QueryError(f"bad node {node}")

    def predicate(value) -> bool:
        out = evaluate(ast, value)
        if out is MISSING:
            return False
        return bool(out)

    return predicate


def _coerce(lv, rv):
    """bytes vs hex-string comparisons; enum ints vs ints are already
    compatible."""
    if isinstance(lv, bytes) and isinstance(rv, str):
        try:
            rv = bytes.fromhex(rv)
        except ValueError:
            rv = rv.encode()
    elif isinstance(rv, bytes) and isinstance(lv, str):
        try:
            lv = bytes.fromhex(lv)
        except ValueError:
            lv = lv.encode()
    return lv, rv


def query_entries(entries, src: str):
    """Filter an iterable of decoded XDR values by a query string."""
    pred = compile_query(src)
    return [e for e in entries if pred(e)]
