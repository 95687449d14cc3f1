"""Exception-safety & resource-discipline rules (detlint v2 layer 3).

Rules
-----
safety-swallow-except
    In a consensus module: a bare ``except:`` (always), or an
    ``except Exception/BaseException:`` whose handler body does NOTHING
    — only ``pass``/``continue``/``...``/bare ``return``/``return
    None``.  A decode guard that returns an error *value*
    (``return ADD_STATUS_ERROR``) or falls back to another code path is
    legitimate robustness; a silent swallow of every exception class in
    consensus scope can hide a fork in progress.  Narrow the type
    (``except XdrError``) or make the handler act (counter/log/raise).
safety-resource-ctx
    In ``bucket/``: a builtin ``open()`` / ``os.open()`` / ``os.fdopen``
    / ``mmap.mmap()`` whose handle is neither (a) a ``with`` context
    item, nor (b) stored to an attribute somewhere in the enclosing
    function (long-lived cached handles like DiskBucket's pread fd have
    lifecycle management by design).  Everything else leaks the fd on
    the first exception between open and close — under the merge worker
    pool that is an fd-exhaustion outage, not a warning.
safety-mutable-default
    A mutable default argument (``[]``/``{}``/``set()``/``dict()``/
    ``list()``) on a function in a consensus module: call-to-call state
    bleed in consensus scope is a determinism hazard, not a style nit.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .engine import ContextVisitor, FileInfo, Finding, dotted_name as _dotted

_BROAD = {"Exception", "BaseException"}
_OPENERS_NAME = {"open"}
_OPENERS_DOTTED = {"os.open", "os.fdopen", "io.open", "mmap.mmap"}


def _is_swallow_body(body: List[ast.stmt]) -> bool:
    """True when the handler does nothing observable."""
    for stmt in body:
        if isinstance(stmt, ast.Pass) or isinstance(stmt, ast.Continue):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring / ellipsis
        if isinstance(stmt, ast.Return) and (
                stmt.value is None
                or (isinstance(stmt.value, ast.Constant)
                    and stmt.value.value is None)):
            continue
        return False
    return True


class _ExceptVisitor(ContextVisitor):
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.add("safety-swallow-except", node,
                     "bare 'except:' in consensus scope — name the "
                     "exception types this handler is licensed to eat")
        else:
            name = None
            if isinstance(node.type, ast.Name):
                name = node.type.id
            elif isinstance(node.type, ast.Attribute):
                name = node.type.attr
            if name in _BROAD and _is_swallow_body(node.body):
                self.add("safety-swallow-except", node,
                         f"'except {name}:' silently swallowed in "
                         "consensus scope — narrow the type or make "
                         "the handler act (log/counter/raise)")
        self.generic_visit(node)


class _ResourceVisitor(ContextVisitor):
    """Per-function: collect with-item opens and attribute-stored
    handles first, then flag the rest."""

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self._scan(node)
        self.stack.pop()
        ContextVisitor._visit_func(self, node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _scan(self, func) -> None:
        from .determinism import _shallow_walk

        ctx_opens = set()
        attr_stored_names = set()
        for node in _shallow_walk(func):
            if isinstance(node, ast.With):
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if self._is_open(sub):
                            ctx_opens.add(id(sub))
            elif isinstance(node, ast.Assign):
                # self.x = fd / self.x = open(...): lifecycle-managed
                stores_attr = any(isinstance(t, ast.Attribute)
                                  for t in node.targets)
                if stores_attr:
                    if self._is_open(node.value):
                        ctx_opens.add(id(node.value))
                    d = _dotted(node.value)
                    if d is not None:
                        attr_stored_names.add(d)
        for node in _shallow_walk(func):
            if not self._is_open(node) or id(node) in ctx_opens:
                continue
            assigned = self._assigned_name(func, node)
            if assigned is not None and assigned in attr_stored_names:
                continue
            self.add("safety-resource-ctx", node,
                     "file/mmap opened outside a context manager (and "
                     "never stored to an attribute) — the handle leaks "
                     "on the first exception before close")

    @staticmethod
    def _is_open(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if isinstance(node.func, ast.Name):
            return node.func.id in _OPENERS_NAME
        d = _dotted(node.func)
        return d in _OPENERS_DOTTED

    @staticmethod
    def _assigned_name(func, call: ast.Call) -> Optional[str]:
        from .determinism import _shallow_walk

        for node in _shallow_walk(func):
            if isinstance(node, ast.Assign) and node.value is call:
                for t in node.targets:
                    d = _dotted(t)
                    if d is not None:
                        return d
        return None


class _MutableDefaultVisitor(ContextVisitor):
    def _visit_func(self, node) -> None:
        args = node.args
        for default in list(args.defaults) + [
                d for d in args.kw_defaults if d is not None]:
            if self._is_mutable(default):
                self.stack.append(node.name)
                self.add("safety-mutable-default", default,
                         f"mutable default argument on {node.name}() in "
                         "consensus scope — one shared object across "
                         "every call (use None + in-body default)")
                self.stack.pop()
        ContextVisitor._visit_func(self, node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    @staticmethod
    def _is_mutable(node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("list", "dict", "set", "bytearray"))


def check(info: FileInfo) -> List[Finding]:
    findings: List[Finding] = []
    if info.in_consensus():
        for visitor in (_ExceptVisitor(info),
                        _MutableDefaultVisitor(info)):
            visitor.visit(info.tree)
            findings.extend(visitor.findings)
    parts = info.path.split("/")
    if "bucket" in parts:
        v = _ResourceVisitor(info)
        v.visit(info.tree)
        findings.extend(v.findings)
    return findings
