"""Module-level call graph over the package — the substrate for the
interprocedural determinism-taint pass (tools/lint/interproc.py).

Each analyzed file yields one JSON-serializable *file summary*: every
function/method it defines with (a) the call sites the resolver can
bind statically, (b) the nondeterminism SOURCES the function contains
directly, and (c) whether it calls a consensus hash/serialize/tally
sink.  Summaries are deliberately resolution-independent (raw call
descriptors, not resolved keys) so the ``--changed`` cache can reuse an
unchanged file's summary verbatim while the cross-file binding is
recomputed each run against whatever file set is in scope.

Resolution is conservative by design: bare names bind to same-module
functions or from-imports, ``self.m()`` binds within the enclosing
class (then any same-module method), ``alias.f()`` binds through the
import map (absolute and relative imports both).  Attribute calls on
arbitrary objects are dropped — a blind spot documented in COVERAGE.md,
traded for a near-zero false-positive rate.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .engine import PACKAGE, FileInfo, dotted_name as _dotted
from .determinism import (
    _DATETIME_METHODS, _ORDER_INSENSITIVE_CONSUMERS, _SINKS_EXACT,
    _SINKS_SUFFIX, _WALLCLOCK_MODS, _ImportMap, _is_set_expr,
    _mentions_ledger_value, _set_annotation, _shallow_walk, _unwrap_iter,
    is_sanctioned_timing_call,
)

#: modules whose time/env reads are sanctioned by architecture — the
#: virtual clock IS the time source, tracing/metrics/logging feed only
#: observability, the scheduler budgets wall time, device probes are
#: host-local, and main/config.py is the one sanctioned os.environ
#: boundary.  Functions here are never taint sources or carriers.
SANCTIONED_MODULES = frozenset({
    f"{PACKAGE}/utils/clock.py",
    f"{PACKAGE}/utils/tracing.py",
    f"{PACKAGE}/utils/metrics.py",
    f"{PACKAGE}/utils/logging.py",
    f"{PACKAGE}/utils/scheduler.py",
    f"{PACKAGE}/utils/device.py",
    # observation-only telemetry, same standing as tracing.py: the
    # lifecycle tracker's and vitals sampler's wallclock reads live in
    # these files and feed only histograms/gauges, never consensus
    # values (pinned by tests/test_detlint.py)
    f"{PACKAGE}/utils/txtrace.py",
    f"{PACKAGE}/utils/vitals.py",
    f"{PACKAGE}/main/config.py",
})

#: taint stops propagating after this many call edges; chains this deep
#: are beyond what a reviewer can act on and beyond what the
#: name-based resolver stays precise for (documented in COVERAGE.md)
MAX_TAINT_DEPTH = 6

#: pragma rules that sanction a taint source at its own line: the
#: specific v1 rule for that source kind, or the interproc rule itself
_SOURCE_RULE_BY_KIND = {
    "wallclock": "det-wallclock",
    "environ": "det-wallclock",
    "id": "det-interproc-taint",
    "unsorted-iter": "det-unsorted-iter",
    "float-consensus": "det-float-consensus",
}
INTERPROC_RULE = "det-interproc-taint"


def module_of(path: str) -> str:
    """'stellar_core_tpu/scp/tally.py' -> 'stellar_core_tpu_torch.scp.tally'."""
    mod = path[:-3] if path.endswith(".py") else path
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def _resolve_relative(path: str, level: int, module: Optional[str]) -> str:
    """Absolute dotted module for a level-N relative import from
    ``path`` (``from ..utils import tracing`` in scp/tally.py ->
    stellar_core_tpu_torch.utils)."""
    pkg_parts = path.split("/")[:-1]  # containing package
    up = level - 1
    if up:
        pkg_parts = pkg_parts[:-up] if up <= len(pkg_parts) else []
    base = ".".join(pkg_parts)
    if module:
        return f"{base}.{module}" if base else module
    return base


@dataclass
class FuncSummary:
    context: str                  # dotted class/method path in the file
    line: int
    calls: List[dict] = field(default_factory=list)
    sources: List[Tuple[str, str, int]] = field(default_factory=list)
    sink: bool = False

    def to_json(self) -> dict:
        return {"context": self.context, "line": self.line,
                "calls": self.calls,
                "sources": [list(s) for s in self.sources],
                "sink": self.sink}

    @classmethod
    def from_json(cls, d: dict) -> "FuncSummary":
        return cls(context=d["context"], line=d["line"],
                   calls=list(d["calls"]),
                   sources=[tuple(s) for s in d["sources"]],
                   sink=bool(d["sink"]))


class _Imports(_ImportMap):
    """The determinism-pass import map plus absolute resolution of
    relative imports (the AST keeps the level separately)."""

    def __init__(self, info: FileInfo):
        super().__init__(info.tree)
        self.module_member: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(info.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    mod = _resolve_relative(info.path, node.level,
                                            node.module)
                else:
                    mod = node.module or ""
                for a in node.names:
                    local = a.asname or a.name
                    self.module_member[local] = (mod, a.name)


def _source_sanctioned(info: FileInfo, line: int, kind: str) -> bool:
    """A pragma at the source line (or the line above) for the matching
    v1 rule, the interproc rule, or '*' sanctions the source — one
    pragma at the origin kills every derived chain."""
    ok = {_SOURCE_RULE_BY_KIND.get(kind, ""), INTERPROC_RULE, "*"}
    for ln in (line, line - 1):
        rules = info.pragmas.get(ln)
        if rules and rules & ok:
            return True
    return False


class _FuncScanner:
    """Extracts one function's summary (shallow body only — nested defs
    are their own summaries)."""

    def __init__(self, info: FileInfo, imports: _Imports,
                 context: str, cls: Optional[str], node) -> None:
        self.info = info
        self.imports = imports
        self.summary = FuncSummary(context=context, line=node.lineno)
        self.cls = cls
        self.node = node

    def scan(self) -> FuncSummary:
        self._scan_calls_and_sources()
        self._scan_unsorted_iteration()
        return self.summary

    # -- call descriptors ---------------------------------------------------

    def _describe_call(self, call: ast.Call) -> Optional[dict]:
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.imports.module_member:
                mod, member = self.imports.module_member[name]
                return {"mod": mod, "name": member, "line": call.lineno}
            return {"name": name, "line": call.lineno}
        if isinstance(func, ast.Attribute):
            base = _dotted(func.value)
            if base == "self":
                return {"name": func.attr, "self": self.cls or "",
                        "line": call.lineno}
            if base is None:
                return None
            # alias.f(): plain `import x.y as alias` or a module bound
            # by `from pkg import module`
            mod = self.imports.mod_alias.get(base)
            if mod is None and base in self.imports.module_member:
                pmod, member = self.imports.module_member[base]
                mod = f"{pmod}.{member}" if pmod else member
            if mod is not None:
                return {"mod": mod, "name": func.attr, "line": call.lineno}
            return None  # unbound object attribute: dropped (blind spot)
        return None

    def _scan_calls_and_sources(self) -> None:
        s = self.summary
        sanctioned_file = self.info.path in SANCTIONED_MODULES
        for node in _shallow_walk(self.node):
            if isinstance(node, ast.Call):
                target = self.imports.resolve_call(node.func)
                if not sanctioned_file:
                    kindet = self._call_source_kind(node, target)
                    if kindet is not None:
                        kind, detail = kindet
                        if not _source_sanctioned(self.info, node.lineno,
                                                  kind):
                            s.sources.append((kind, detail, node.lineno))
                self._note_sink(node)
                d = self._describe_call(node)
                if d is not None:
                    s.calls.append(d)
            elif isinstance(node, ast.Attribute) and node.attr == "environ":
                base = _dotted(node.value)
                if base is not None and not sanctioned_file and \
                        self.imports.mod_alias.get(base, base) == "os":
                    if not _source_sanctioned(self.info, node.lineno,
                                              "environ"):
                        s.sources.append(("environ", "os.environ",
                                          node.lineno))
            elif isinstance(node, ast.BinOp) and \
                    isinstance(node.op, ast.Div) and not sanctioned_file:
                if (_mentions_ledger_value(node.left)
                        or _mentions_ledger_value(node.right)):
                    if not _source_sanctioned(self.info, node.lineno,
                                              "float-consensus"):
                        s.sources.append((
                            "float-consensus",
                            "float division on a ledger value",
                            node.lineno))

    def _call_source_kind(self, node: ast.Call,
                          target: Optional[str]) -> Optional[tuple]:
        if isinstance(node.func, ast.Name) and node.func.id == "id" \
                and node.args:
            return ("id", "id()")
        if not target or "." not in target:
            return None
        if is_sanctioned_timing_call(target):
            return None
        mod, _, attr = target.rpartition(".")
        if mod in ("datetime.datetime", "datetime.date", "datetime") and \
                attr in _DATETIME_METHODS:
            return ("wallclock", f"{target}()")
        banned = _WALLCLOCK_MODS.get(mod)
        if banned and attr in banned:
            kind = "environ" if mod == "os" else "wallclock"
            return (kind, f"{target}()")
        return None

    def _note_sink(self, call: ast.Call) -> None:
        name = None
        if isinstance(call.func, ast.Attribute):
            name = call.func.attr
        elif isinstance(call.func, ast.Name):
            name = call.func.id
        if name is None:
            return
        if name in _SINKS_EXACT or \
                any(name.lower().endswith(sfx) for sfx in _SINKS_SUFFIX):
            self.summary.sink = True

    # -- order-carrying unsorted iteration ----------------------------------

    def _scan_unsorted_iteration(self) -> None:
        """A function taints its callers through iteration order only
        when it BUILDS an order-carrying value from an unsorted dict
        view / set: a list-comp/genexp over one, a yield inside such a
        loop, or .append/.extend in its body.  Plain counting loops and
        order-insensitive consumers (sorted/sum/set/...) are exempt —
        same exemptions as the v1 intra-function rule."""
        if self.info.path in SANCTIONED_MODULES:
            return
        known_sets = self._set_names()
        exempt: Set[int] = set()
        for node in _shallow_walk(self.node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in _ORDER_INSENSITIVE_CONSUMERS:
                for a in node.args:
                    if isinstance(a, (ast.ListComp, ast.GeneratorExp)):
                        exempt.add(id(a))
        for node in _shallow_walk(self.node):
            if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                if id(node) in exempt:
                    continue
                for gen in node.generators:
                    d = self._unsorted_detail(gen.iter, known_sets)
                    if d is not None:
                        self._add_iter_source(d, node.lineno)
            elif isinstance(node, ast.For):
                d = self._unsorted_detail(node.iter, known_sets)
                if d is None:
                    continue
                if self._loop_carries_order(node):
                    self._add_iter_source(d, node.lineno)

    def _add_iter_source(self, detail: str, line: int) -> None:
        if not _source_sanctioned(self.info, line, "unsorted-iter"):
            self.summary.sources.append(("unsorted-iter", detail, line))

    def _set_names(self) -> Set[str]:
        names: Set[str] = set()
        for node in _shallow_walk(self.node):
            if isinstance(node, ast.Assign) and _is_set_expr(node.value):
                for t in node.targets:
                    d = _dotted(t)
                    if d is not None:
                        names.add(d)
            elif isinstance(node, ast.AnnAssign) and (
                    _set_annotation(node.annotation)
                    or (node.value is not None
                        and _is_set_expr(node.value))):
                d = _dotted(node.target)
                if d is not None:
                    names.add(d)
        for arg in getattr(self.node.args, "args", []):
            if _set_annotation(arg.annotation):
                names.add(arg.arg)
        return names

    def _unsorted_detail(self, it: ast.AST,
                         known_sets: Set[str]) -> Optional[str]:
        it = _unwrap_iter(it)
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "sorted":
            return None
        if isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("items", "values", "keys") and not it.args:
            return f"unsorted .{it.func.attr}() iteration"
        d = _dotted(it)
        if d is not None and d in known_sets:
            return f"unsorted set '{d}' iteration"
        return None

    @staticmethod
    def _loop_carries_order(loop: ast.For) -> bool:
        for node in ast.walk(loop):
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                return True
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("append", "extend", "insert",
                                       "appendleft"):
                return True
        return False


class _FileScanner(ast.NodeVisitor):
    def __init__(self, info: FileInfo):
        self.info = info
        self.imports = _Imports(info)
        self.stack: List[str] = []
        self.cls_stack: List[str] = []
        self.functions: List[FuncSummary] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        context = ".".join(self.stack)
        cls = self.cls_stack[-1] if self.cls_stack else None
        self.functions.append(
            _FuncScanner(self.info, self.imports, context, cls,
                         node).scan())
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def summarize_file(info: FileInfo) -> List[FuncSummary]:
    """All function summaries of one parsed file."""
    scanner = _FileScanner(info)
    scanner.visit(info.tree)
    return scanner.functions


# ---------------------------------------------------------------------------
# graph binding (recomputed every run over whichever summaries exist)
# ---------------------------------------------------------------------------

@dataclass
class Graph:
    # key = f"{path}::{context}"
    funcs: Dict[str, FuncSummary] = field(default_factory=dict)
    path_of: Dict[str, str] = field(default_factory=dict)
    # resolved call edges: key -> [(callee_key, line), ...]
    edges: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)


def _index_functions(summaries: Dict[str, List[FuncSummary]]):
    """(path, bare) -> key for module-level defs; (path, cls, meth) and
    (path, meth) for methods."""
    module_level: Dict[Tuple[str, str], str] = {}
    methods: Dict[Tuple[str, str, str], str] = {}
    any_method: Dict[Tuple[str, str], List[str]] = {}
    for path, funcs in summaries.items():
        for f in funcs:
            key = f"{path}::{f.context}"
            parts = f.context.split(".")
            if len(parts) == 1:
                module_level[(path, parts[0])] = key
            else:
                methods[(path, parts[-2], parts[-1])] = key
                any_method.setdefault((path, parts[-1]), []).append(key)
    return module_level, methods, any_method


def build(summaries: Dict[str, List[FuncSummary]]) -> Graph:
    g = Graph()
    module_files = {module_of(p): p for p in summaries}
    module_level, methods, any_method = _index_functions(summaries)
    for path, funcs in summaries.items():
        for f in funcs:
            key = f"{path}::{f.context}"
            g.funcs[key] = f
            g.path_of[key] = path
            out: List[Tuple[str, int]] = []
            for call in f.calls:
                for callee in _bind(call, path, module_files,
                                    module_level, methods, any_method):
                    out.append((callee, call["line"]))
            g.edges[key] = out
    return g


def _bind(call: dict, path: str, module_files, module_level, methods,
          any_method) -> List[str]:
    name = call["name"]
    if "mod" in call:
        target = module_files.get(call["mod"])
        if target is None:
            # either `name` is a module object (from pkg import module —
            # modules are not callables we track) or the module is
            # outside the analyzed set: unbound either way
            return []
        key = module_level.get((target, name))
        return [key] if key else []
    if "self" in call:
        key = methods.get((path, call["self"], name))
        if key:
            return [key]
        return any_method.get((path, name), [])
    key = module_level.get((path, name))
    return [key] if key else []
