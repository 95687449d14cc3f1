"""Minimal TOML-subset parser — fallback for Python < 3.11 hosts with no
``tomllib`` (the node's config loader must work on the bare container).

Supports exactly what node config files use: ``#`` comments, bare
``key = value`` pairs, ``[table]`` / ``[table.sub]`` headers,
``[[array-of-tables]]``, and values that are strings, booleans, integers,
floats, or (possibly multi-line) arrays of those.  Unsupported syntax
raises ValueError rather than mis-parsing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple


def load(f) -> Dict[str, Any]:
    data = f.read()
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    return loads(data)


def loads(text: str) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    cur = root
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue
        if line.startswith("[["):
            if not line.endswith("]]"):
                raise ValueError(f"bad table header: {line}")
            tbl = _descend(root, line[2:-2].strip())
            parent, leaf = tbl
            arr = parent.setdefault(leaf, [])
            if not isinstance(arr, list):
                raise ValueError(f"conflicting table {line}")
            cur = {}
            arr.append(cur)
        elif line.startswith("["):
            if not line.endswith("]"):
                raise ValueError(f"bad table header: {line}")
            parent, leaf = _descend(root, line[1:-1].strip())
            cur = parent.setdefault(leaf, {})
            if not isinstance(cur, dict):
                raise ValueError(f"conflicting table {line}")
        else:
            if "=" not in line:
                raise ValueError(f"bad line: {line}")
            key, _, rest = line.partition("=")
            key = key.strip().strip('"')
            rest = rest.strip()
            # multi-line arrays: keep consuming until brackets balance
            while rest.startswith("[") and not _balanced(rest):
                if i >= len(lines):
                    raise ValueError(f"unterminated array for {key}")
                rest += " " + _strip_comment(lines[i]).strip()
                i += 1
            cur[key] = _value(rest)
    return root


def _scan(s: str):
    """Yield (index, char, in_string) with backslash escapes honored
    inside strings — the one quote-state walker every helper shares, so
    '\\"' inside a string can never flip the state."""
    in_str = False
    escaped = False
    for i, ch in enumerate(s):
        if in_str and escaped:
            escaped = False
            yield i, ch, True
            continue
        if in_str and ch == "\\":
            escaped = True
            yield i, ch, True
            continue
        if ch == '"':
            yield i, ch, in_str  # the quote itself reports the old state
            in_str = not in_str
            continue
        yield i, ch, in_str


def _strip_comment(line: str) -> str:
    for i, ch, in_str in _scan(line):
        if ch == "#" and not in_str:
            return line[:i]
    return line


def _balanced(s: str) -> bool:
    depth = 0
    for _, ch, in_str in _scan(s):
        if not in_str:
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
    return depth == 0


def _descend(root: Dict[str, Any],
             dotted: str) -> Tuple[Dict[str, Any], str]:
    parts = [p.strip().strip('"') for p in dotted.split(".")]
    node = root
    for p in parts[:-1]:
        nxt = node.setdefault(p, {})
        if isinstance(nxt, list):
            nxt = nxt[-1]
        node = nxt
    return node, parts[-1]


def _value(s: str) -> Any:
    s = s.strip()
    if not s:
        raise ValueError("empty value")
    if s.startswith('"'):
        body = []
        escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r"}
        escaped = False
        closed_at = None
        for i in range(1, len(s)):
            ch = s[i]
            if escaped:
                body.append(escapes.get(ch, ch))
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                closed_at = i
                break
            else:
                body.append(ch)
        if closed_at != len(s) - 1:
            raise ValueError(f"bad string: {s}")
        return "".join(body)
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"bad array: {s}")
        return [_value(el) for el in _split_array(s[1:-1])]
    if s == "true":
        return True
    if s == "false":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"unsupported TOML value: {s}")


def _split_array(body: str) -> List[str]:
    out = []
    depth = 0
    cur = []
    for _, ch, in_str in _scan(body):
        if not in_str and ch == "[":
            depth += 1
            cur.append(ch)
        elif not in_str and ch == "]":
            depth -= 1
            cur.append(ch)
        elif not in_str and ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return [x.strip() for x in out if x.strip()]
