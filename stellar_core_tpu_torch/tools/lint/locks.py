"""Lock-discipline rules (family b) for the threaded subsystems
(bucket merge pipeline, native library loader, device probe, quorum
intersection bridge).

Convention: a shared field declares its lock with a trailing comment on
its (ann-)assignment line::

    self._bg_outputs: set = set()  # guarded-by: _bg_lock
    _lib = None                    # guarded-by: _lock

Rules
-----
lock-unguarded-write   a mutation of a guarded field (assignment,
                       augmented assignment, mutating method call like
                       .add/.pop/.update, subscript store/delete)
                       lexically outside a ``with <lock>:`` block.
                       ``__init__`` bodies and module top-level are
                       exempt: construction happens-before sharing.
lock-order             two locks acquired in opposite nesting orders
                       within one file — the classic ABBA deadlock
                       shape.  Per-file on purpose: lock names are only
                       unambiguous inside their defining module
                       (`_lock` in native/__init__.py and `_lock` in
                       utils/device.py are different objects).
lock-unknown-guard     a guarded-by annotation naming a lock that is
                       never acquired anywhere in the file (typo guard).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import ContextVisitor, FileInfo, Finding, dotted_name as _dotted

_MUTATING_METHODS = {
    "add", "discard", "remove", "pop", "popitem", "clear", "update",
    "append", "extend", "insert", "setdefault", "appendleft",
}


def _field_name(node: ast.AST) -> Optional[str]:
    """Normalized field name: 'self.x' -> 'x', bare 'x' -> 'x'."""
    d = _dotted(node)
    if d is None:
        return None
    if d.startswith("self."):
        d = d[len("self."):]
    if "." in d:
        return None  # deeper chains (self.a.b) are not declarable fields
    return d


def _lock_name(node: ast.AST) -> Optional[str]:
    """Normalized lock name from a with-item expression."""
    return _field_name(node)


def _collect_guards(info: FileInfo) -> Dict[str, Tuple[str, int]]:
    """field -> (lock, decl_line) from '# guarded-by:' annotations
    attached to (ann-)assignment lines."""
    guards: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(info.tree):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        lock = info.guards.get(node.lineno)
        if lock is None and getattr(node, "end_lineno", None):
            for ln in range(node.lineno, node.end_lineno + 1):
                if ln in info.guards:
                    lock = info.guards[ln]
                    break
        if lock is None:
            continue
        for t in targets:
            f = _field_name(t)
            if f is not None:
                guards[f] = (lock, node.lineno)
    return guards


class _LockVisitor(ContextVisitor):
    def __init__(self, info: FileInfo, guards: Dict[str, Tuple[str, int]]):
        super().__init__(info)
        self.guards = guards
        self.held: List[str] = []          # current lock nesting
        self.acquired: Set[str] = set()    # every lock ever acquired
        # (outer, inner) -> first witness (file, line)
        self.order: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.func_depth = 0

    # -- with-block tracking ------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            lock = _lock_name(item.context_expr)
            if lock is not None and self._looks_like_lock(lock):
                self.acquired.add(lock)
                for outer in self.held:
                    if outer != lock:
                        self.order.setdefault(
                            (outer, lock),
                            (self.info.path, node.lineno))
                self.held.append(lock)
                pushed += 1
        self.generic_visit(node)
        for _ in range(pushed):
            self.held.pop()

    def _looks_like_lock(self, name: str) -> bool:
        if any(name == lock for lock, _ in self.guards.values()):
            return True
        return "lock" in name.lower() or "mutex" in name.lower()

    # -- function / exemption tracking --------------------------------------

    def _visit_func(self, node) -> None:
        self.func_depth += 1
        ContextVisitor._visit_func(self, node)
        self.func_depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _exempt(self) -> bool:
        """Construction contexts: module top level and __init__."""
        if self.func_depth == 0:
            return True
        return bool(self.stack) and self.stack[-1] == "__init__"

    def _check_mutation(self, node: ast.AST, field_expr: ast.AST) -> None:
        f = _field_name(field_expr)
        if f is None or f not in self.guards:
            return
        lock, decl_line = self.guards[f]
        if getattr(node, "lineno", 0) == decl_line:
            return  # the declaration itself
        if self._exempt():
            return
        if lock in self.held:
            return
        self.add("lock-unguarded-write", node,
                 f"write to '{f}' (guarded-by: {lock}) outside "
                 f"'with {lock}:'")

    # -- mutations -----------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._check_mutation(node, t.value)
            else:
                self._check_mutation(node, t)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            if isinstance(node.target, ast.Subscript):
                self._check_mutation(node, node.target.value)
            else:
                self._check_mutation(node, node.target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Subscript):
            self._check_mutation(node, node.target.value)
        else:
            self._check_mutation(node, node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._check_mutation(node, t.value)
            else:
                self._check_mutation(node, t)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATING_METHODS:
            self._check_mutation(node, node.func.value)
        self.generic_visit(node)


def check(infos: List[FileInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for info in infos:
        guards = _collect_guards(info)
        v = _LockVisitor(info, guards)
        v.visit(info.tree)
        findings.extend(v.findings)
        # unknown-guard: declared lock never acquired in this file
        for f, (lock, line) in sorted(guards.items()):
            if lock not in v.acquired:
                findings.append(Finding(
                    rule="lock-unknown-guard", file=info.path, line=line,
                    col=0, context="<module>",
                    message=(f"'{f}' declares guarded-by: {lock} but "
                             f"'with {lock}:' never appears in this file"),
                    line_text=info.line_text(line)))
        # ABBA within this file: both (a, b) and (b, a) witnessed —
        # same-NAMED locks in different modules are different objects,
        # so cross-file pairing would both false-positive and mask
        seen: Set[Tuple[str, str]] = set()
        for (a, b), (path, line) in sorted(v.order.items(),
                                           key=lambda kv: kv[1]):
            if (b, a) in v.order and (b, a) not in seen:
                seen.add((a, b))
                other_path, other_line = v.order[(b, a)]
                findings.append(Finding(
                    rule="lock-order", file=path, line=line, col=0,
                    context="<module>",
                    message=(f"lock order inversion: {a} -> {b} here "
                             f"but {b} -> {a} at "
                             f"{other_path}:{other_line}"),
                    line_text=info.line_text(line)))
    return findings
