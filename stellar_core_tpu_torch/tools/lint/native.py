"""Native-kernel auditor (detlint v2 layer 2): a lightweight lexer over
``native/*.cpp`` / ``*.c`` that turns three runtime-only disciplines
into static, per-commit guarantees.

Rules
-----
native-lockstep
    Every protocol constant the C++ kernels hardcode is pinned in an
    explicit manifest (tools/lint/lockstep.json) against its canonical
    value AND its Python source of truth.  Drift in EITHER file against
    the pinned value fails the gate — changing a constant legitimately
    forces touching kernel + Python + manifest in one commit, which is
    exactly the "did you port it?" question the runtime
    ``_constants_in_lockstep`` check could only ask after deploy.  A
    pattern that stops matching is itself a finding (stale manifest
    never degrades to silence).
native-gil-api
    A CPython API token (``Py*``) inside a ``Py_BEGIN_ALLOW_THREADS``
    .. ``Py_END_ALLOW_THREADS`` region — calling into the interpreter
    without the GIL is memory corruption, not an error return.
    ``Py_BLOCK_THREADS``/``Py_UNBLOCK_THREADS`` re-acquisition windows
    are honoured; type names (PyObject, Py_ssize_t) are exempt.
native-null-unchecked
    A Py allocator/constructor result (``PyList_New``, ``PyTuple_Pack``,
    ``Py_BuildValue``, ``PySequence_Fast``, ``PyMem_Malloc``, ...)
    assigned to a variable that is not NULL-checked within the next few
    lines, or nested directly into another call (leak + NULL deref on
    allocation failure — the exact bug class PR 6's review pass fixed
    by hand).  ``return <alloc>(...)`` propagates to the caller and is
    exempt.
native-srchash
    Every committed ``.so`` must carry a ``.srchash`` sidecar matching
    the sha256 of its sources (the loader's content-hash staleness
    contract, native/__init__.py) — a stale sidecar means a stale
    consensus kernel could load silently after checkout.

Comments and string literals are masked before token scanning (kernel
comments legitimately NAME Py* functions); lockstep patterns run on the
raw text because several anchor on the kernels' comment discipline.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .engine import REPO, Finding

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "lockstep.json")

#: .so -> sources, in the loader's digest order (native/__init__.py)
SO_SOURCES = {
    "_native.so": ["bucket_merge.cpp", "quorum_enum.cpp"],
    "_xdrpack.so": ["xdr_pack.c"],
    "_applykernel.so": ["apply_kernel.cpp"],
}
NATIVE_DIR = "stellar_core_tpu_torch/native"

_PRAGMA_RE = re.compile(r"(?://|/\*)\s*detlint:\s*allow\(([^)]*)\)")

_GIL_BEGIN = "Py_BEGIN_ALLOW_THREADS"
_GIL_END = "Py_END_ALLOW_THREADS"
_GIL_BLOCK = "Py_BLOCK_THREADS"
_GIL_UNBLOCK = "Py_UNBLOCK_THREADS"
_PY_TOKEN_RE = re.compile(r"\bPy_?[A-Z]\w*")
_GIL_EXEMPT = {
    _GIL_BEGIN, _GIL_END, _GIL_BLOCK, _GIL_UNBLOCK,
    "PyObject", "PyTypeObject", "PyMethodDef", "PyModuleDef",
    "PyMODINIT_FUNC", "PyCFunction",
}

_ALLOC_RE = re.compile(
    r"(?:([A-Za-z_]\w*(?:(?:->|\.)\w+)*)\s*=\s*)?"   # lvalue (a, a->b, a.b)
    r"(?:\(\s*\w+[\w\s*]*\)\s*)?"                    # optional C cast
    r"\b("
    r"Py(?:List_New|Tuple_New|Tuple_Pack|Dict_New|Set_New"
    r"|Bytes_FromStringAndSize|Bytes_FromString|ByteArray_FromStringAndSize"
    r"|Unicode_From\w+|Long_From\w+|Float_From\w+|Sequence_Fast"
    r"|Mem_Malloc|Mem_Realloc|Mem_Calloc|Err_NewException"
    r"|Module_Create|Import_ImportModule|Object_Call\w*)"
    r"|Py_BuildValue)\s*\(")
_NULL_CHECK_WINDOW = 10
_SPLIT_LVALUE_RE = re.compile(r"([A-Za-z_]\w*(?:(?:->|\.)\w+)*)\s*=\s*$")


@dataclass
class NativeInfo:
    """Duck-typed stand-in for engine.FileInfo over a C/C++ source."""
    path: str
    source: str
    lines: List[str]
    masked_lines: List[str]
    pragmas: Dict[int, set] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


def _mask(source: str) -> str:
    """Replace comment/string interiors with spaces, preserving line
    structure, so token scans never fire inside prose."""
    out = []
    i, n = 0, len(source)
    mode = None  # None | 'line' | 'block' | '"' | "'"
    while i < n:
        c = source[i]
        if mode is None:
            if c == "/" and i + 1 < n and source[i + 1] == "/":
                mode = "line"
                out.append("  ")
                i += 2
                continue
            if c == "/" and i + 1 < n and source[i + 1] == "*":
                mode = "block"
                out.append("  ")
                i += 2
                continue
            if c in "\"'":
                mode = c
                out.append(c)
                i += 1
                continue
            out.append(c)
            i += 1
        elif mode == "line":
            if c == "\n":
                mode = None
                out.append(c)
            else:
                out.append(" ")
            i += 1
        elif mode == "block":
            if c == "*" and i + 1 < n and source[i + 1] == "/":
                mode = None
                out.append("  ")
                i += 2
                continue
            out.append(c if c == "\n" else " ")
            i += 1
        else:  # string literal
            if c == "\\" and i + 1 < n:
                out.append("  ")
                i += 2
                continue
            if c == mode:
                mode = None
                out.append(c)
            else:
                out.append(c if c == "\n" else " ")
            i += 1
    return "".join(out)


def parse_native(relpath: str, source: str) -> NativeInfo:
    info = NativeInfo(path=relpath.replace(os.sep, "/"), source=source,
                      lines=source.splitlines(),
                      masked_lines=_mask(source).splitlines())
    for i, raw in enumerate(info.lines, start=1):
        m = _PRAGMA_RE.search(raw)
        if m:
            info.pragmas[i] = {r.strip() for r in m.group(1).split(",")
                               if r.strip()}
    return info


# ---------------------------------------------------------------------------
# native-gil-api
# ---------------------------------------------------------------------------

def _check_gil(info: NativeInfo) -> List[Finding]:
    findings: List[Finding] = []
    in_region = False
    blocked = False
    for lineno, line in enumerate(info.masked_lines, start=1):
        if _GIL_BEGIN in line:
            in_region = True
            blocked = False
            continue
        if _GIL_END in line:
            in_region = False
            continue
        if not in_region:
            continue
        if _GIL_BLOCK in line:
            blocked = True
        if _GIL_UNBLOCK in line:
            blocked = False
            continue
        if blocked:
            continue
        for m in _PY_TOKEN_RE.finditer(line):
            tok = m.group(0)
            if tok in _GIL_EXEMPT:
                continue
            findings.append(Finding(
                rule="native-gil-api", file=info.path, line=lineno,
                col=m.start(), context="<native>",
                message=(f"CPython API '{tok}' inside a "
                         "Py_BEGIN/END_ALLOW_THREADS region — the GIL "
                         "is not held here"),
                line_text=info.line_text(lineno)))
    return findings


# ---------------------------------------------------------------------------
# native-null-unchecked
# ---------------------------------------------------------------------------

def _null_checked(var: str, lines: List[str], start_idx: int) -> bool:
    v = re.escape(var)
    pat = re.compile(
        rf"(!\s*{v}\b|\b{v}\s*==\s*NULL|NULL\s*==\s*{v}\b"
        rf"|\b{v}\s*!=\s*NULL|\b{v}\s*\?"
        rf"|if\s*\(\s*{v}\b"          # plain truthiness: if (enc) / (enc &&
        rf"|return\s+{v}\s*;)")       # propagated to the caller as-is
    end = min(len(lines), start_idx + _NULL_CHECK_WINDOW)
    for i in range(start_idx, end):
        if pat.search(lines[i]):
            return True
    return False


def _check_null(info: NativeInfo) -> List[Finding]:
    findings: List[Finding] = []
    lines = info.masked_lines
    for lineno, line in enumerate(lines, start=1):
        for m in _ALLOC_RE.finditer(line):
            before = line[:m.start()].rstrip()
            if before.endswith("return"):
                continue  # caller owns the NULL
            var, fn = m.group(1), m.group(2)
            if not var and not before and lineno >= 2:
                # assignment split across lines: `KernelError =\n  PyX(...)`
                sm = _SPLIT_LVALUE_RE.search(lines[lineno - 2])
                if sm:
                    var = sm.group(1)
            if var:
                if _null_checked(var, lines, lineno - 1):
                    continue
                msg = (f"'{var} = {fn}(...)' never NULL-checked within "
                       f"{_NULL_CHECK_WINDOW} lines — allocation "
                       "failure dereferences NULL")
            elif before.endswith(("(", ",")):
                msg = (f"{fn}(...) result nested into another call — "
                       "unchecked NULL and a leak on failure")
            else:
                msg = (f"{fn}(...) result discarded or unchecked — "
                       "allocation failure is invisible here")
            findings.append(Finding(
                rule="native-null-unchecked", file=info.path, line=lineno,
                col=m.start(), context="<native>", message=msg,
                line_text=info.line_text(lineno)))
    return findings


# ---------------------------------------------------------------------------
# native-lockstep
# ---------------------------------------------------------------------------

def load_manifest(path: str = MANIFEST_PATH) -> List[dict]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["constants"]


def _const_eval(node: ast.AST) -> Optional[int]:
    """Tiny int-expression evaluator for Python constant definitions
    (handles ``2**63 - 1`` without importing the package)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_eval(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _const_eval(node.left), _const_eval(node.right)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, ast.FloorDiv) and b:
            return a // b
        if isinstance(node.op, ast.Pow):
            return a ** b
        if isinstance(node.op, ast.LShift):
            return a << b
        if isinstance(node.op, ast.BitOr):
            return a | b
    return None


def _py_attr_value(source: str, attr: str) -> Optional[Tuple[int, int]]:
    """(value, line) of a module-level ``attr = <int expr>``."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == attr:
                    v = _const_eval(node.value)
                    if v is not None:
                        return v, node.lineno
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and \
                    node.target.id == attr:
                v = _const_eval(node.value)
                if v is not None:
                    return v, node.lineno
    return None


def _py_enum_value(source: str, enum_name: str,
                   member: str) -> Optional[Tuple[int, int]]:
    """(value, line) of ``Enum("<enum_name>", {"<member>": v, ...})``."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "Enum" and len(node.args) >= 2):
            continue
        arg0 = node.args[0]
        if not (isinstance(arg0, ast.Constant)
                and arg0.value == enum_name):
            continue
        d = node.args[1]
        if not isinstance(d, ast.Dict):
            continue
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and k.value == member:
                val = _const_eval(v)
                if val is not None:
                    return val, k.lineno
    return None


def _line_of(source: str, pos: int) -> int:
    return source.count("\n", 0, pos) + 1


def _regex_values(source: str, pattern: str) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for m in re.finditer(pattern, source, re.M | re.S):
        try:
            out.append((int(m.group(1), 0), _line_of(source, m.start(1))))
        except (ValueError, IndexError):
            pass
    return out


def check_lockstep(sources: Dict[str, str],
                   manifest: Optional[List[dict]] = None,
                   root: str = REPO) -> List[Finding]:
    """Diff every manifest constant across kernel source, Python twin
    and the pinned canonical value.  ``sources`` provides in-scope file
    text (the test seam injects drift here); anything absent is read
    from ``root`` so a scoped run still sees both sides.  An unreadable
    manifest is itself a finding — silence is never an option here."""
    if manifest is None:
        try:
            manifest = load_manifest()
        except (OSError, ValueError, KeyError, TypeError) as e:
            return [Finding(
                rule="native-lockstep", file="tools/lint/lockstep.json",
                line=1, col=0, context="<manifest>",
                message=f"lockstep manifest unreadable: {e}",
                line_text="")]

    def text_of(rel: str) -> Optional[str]:
        if rel in sources:
            return sources[rel]
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    findings: List[Finding] = []

    def drift(rel: str, line: int, text: str, msg: str, name: str):
        lt = ""
        if text is not None:
            ls = text.splitlines()
            if 1 <= line <= len(ls):
                lt = ls[line - 1].strip()
        findings.append(Finding(
            rule="native-lockstep", file=rel, line=line, col=0,
            context=name, message=msg, line_text=lt))

    for entry in manifest:
        name = entry["name"]
        want = int(entry["value"])
        cpp = entry["cpp"]
        cpp_text = text_of(cpp["file"])
        if cpp_text is None:
            drift(cpp["file"], 1, None,
                  f"lockstep constant '{name}': kernel source missing",
                  name)
            continue
        got = _regex_values(cpp_text, cpp["pattern"])
        if not got:
            drift(cpp["file"], 1, cpp_text,
                  f"lockstep constant '{name}': manifest pattern no "
                  "longer matches the kernel source (stale manifest or "
                  "renamed constant — update tools/lint/lockstep.json)",
                  name)
        for value, line in got:
            if value != want:
                drift(cpp["file"], line, cpp_text,
                      f"lockstep constant '{name}' drifted in the C "
                      f"kernel: {value} != {want} (Python twin: "
                      f"{entry.get('py', {}).get('file', 'manifest')})",
                      name)
        py = entry.get("py")
        if not py:
            continue
        py_text = text_of(py["file"])
        if py_text is None:
            drift(py["file"], 1, None,
                  f"lockstep constant '{name}': Python twin file "
                  "missing", name)
            continue
        if "attr" in py:
            res = _py_attr_value(py_text, py["attr"])
        elif "enum" in py:
            res = _py_enum_value(py_text, py["enum"][0], py["enum"][1])
        else:
            vals = _regex_values(py_text, py["pattern"])
            res = vals[0] if vals else None
        if res is None:
            drift(py["file"], 1, py_text,
                  f"lockstep constant '{name}': Python twin not found "
                  "(stale manifest — update tools/lint/lockstep.json)",
                  name)
            continue
        pval, pline = res
        if pval != want:
            drift(py["file"], pline, py_text,
                  f"lockstep constant '{name}' drifted on the Python "
                  f"side: {pval} != {want} (kernel: {cpp['file']})",
                  name)
    return findings


# ---------------------------------------------------------------------------
# native-srchash
# ---------------------------------------------------------------------------

def check_srchash(root: str = REPO) -> List[Finding]:
    findings: List[Finding] = []
    ndir = os.path.join(root, NATIVE_DIR)
    if not os.path.isdir(ndir):
        return findings
    # reverse audit: an SO_SOURCES entry naming a source that no longer
    # exists is a stale map (kernel renamed without updating it)
    for so_name, srcs in sorted(SO_SOURCES.items()):
        for s in srcs:
            if not os.path.exists(os.path.join(ndir, s)):
                findings.append(Finding(
                    rule="native-srchash", file=f"{NATIVE_DIR}/{so_name}",
                    line=1, col=0, context="<native>",
                    message=(f"SO_SOURCES maps {so_name} to missing "
                             f"source {s} — update tools/lint/native.py"),
                    line_text=""))
    for name in sorted(os.listdir(ndir)):
        if not name.endswith(".so"):
            continue
        rel = f"{NATIVE_DIR}/{name}"
        srcs = SO_SOURCES.get(name)
        if srcs is None:
            findings.append(Finding(
                rule="native-srchash", file=rel, line=1, col=0,
                context="<native>",
                message=(f"unknown native library {name}: add it to "
                         "tools/lint/native.py SO_SOURCES so its "
                         "sidecar contract is auditable"),
                line_text=""))
            continue
        h = hashlib.sha256()
        try:
            for s in srcs:
                with open(os.path.join(ndir, s), "rb") as fh:
                    h.update(fh.read())
        except OSError:
            findings.append(Finding(
                rule="native-srchash", file=rel, line=1, col=0,
                context="<native>",
                message=f"sources of {name} unreadable: {srcs}",
                line_text=""))
            continue
        try:
            with open(os.path.join(ndir, name + ".srchash")) as fh:
                recorded = fh.read().strip()
        except OSError:
            recorded = None
        if recorded != h.hexdigest():
            findings.append(Finding(
                rule="native-srchash", file=rel, line=1, col=0,
                context="<native>",
                message=(f"{name}.srchash is "
                         f"{'missing' if recorded is None else 'stale'}"
                         " — rebuild the kernel and commit the .so with "
                         "its sidecar (a stale consensus kernel must "
                         "never load)"),
                line_text=""))
    return findings


# ---------------------------------------------------------------------------

def check_native_file(info: NativeInfo) -> List[Finding]:
    """Every rule computable from ONE native source file — the single
    dispatch list shared by the cold run and the --changed cache."""
    findings = _check_gil(info)
    findings.extend(_check_null(info))
    return findings


def check(native_infos: List[NativeInfo],
          py_sources: Optional[Dict[str, str]] = None,
          root: Optional[str] = None,
          run_lockstep: bool = True) -> List[Finding]:
    """Per-file GIL/NULL rules over ``native_infos`` plus the global
    lockstep diff.  ``root`` (when set) additionally enables the
    filesystem-backed srchash sidecar audit."""
    findings: List[Finding] = []
    for info in native_infos:
        findings.extend(check_native_file(info))
    if run_lockstep:
        sources: Dict[str, str] = dict(py_sources or {})
        for info in native_infos:
            sources[info.path] = info.source
        findings.extend(check_lockstep(sources, root=root or REPO))
    if root is not None:
        findings.extend(check_srchash(root))
    return findings
