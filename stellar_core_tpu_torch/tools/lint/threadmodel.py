"""Thread-context model — the substrate for detlint v3's concurrency
rules (tools/lint/concurrency.py).

Each analyzed file yields one JSON-serializable *concurrency summary*
(``FileConc``): per function, the shared-state writes, the lexical lock
acquisitions (with the held-lock prefix at each), every call site (with
the locks held around it), the THREAD ROOTS it declares, and the
thread-affine API touches; per file, the declared locks, the
``# guarded-by:`` table (class-qualified), and the class/base map.

Thread roots recognized statically:

- ``<executor>.submit(fn, ...)`` — the executor's ``thread_name_prefix``
  is resolved through a per-file map of ``ThreadPoolExecutor(...)``
  construction sites (attribute assignments AND lazy factory methods
  like ``ClosePipeline._tails``), so the root context carries the real
  thread name (``worker:close-tail``, ``worker:bucket-merge``, ...);
- ``threading.Thread(target=fn)`` — context ``thread:<fn>``;
- ``ThreadedWork.on_io`` overrides (via the cross-file subclass
  closure) — context ``worker:work-pool``;
- ``<timer>.async_wait(cb)`` — VirtualTimer callbacks fire on the
  crank thread, context ``main``;
- ``gc.callbacks.append(cb)`` — gc callbacks run on WHICHEVER thread
  triggers the collection, context ``any`` (counts as every context).

Contexts then propagate CALLER -> CALLEE through the call graph to a
fixpoint, so every function knows the set of threads it can run on.
Functions with no resolved callers that are not thread roots seed
``main`` (public API, timer/HTTP entry points, test drivers).

Call binding here is deliberately MORE aggressive than the
determinism-taint call graph (callgraph.py): in addition to its
bare-name / ``self.m()`` / ``alias.f()`` resolution, an attribute call
on an arbitrary object (``lm._store_tx_history(...)``) binds iff
exactly ONE function with that name is defined package-wide — the
unique-name (CHA-lite) rule.  Thread contexts flow across objects
(``run_close_tail`` calling LedgerManager methods is exactly how the
tail worker reaches the ledger state), so dropping those edges would
blind the whole analysis; uniqueness keeps the false-edge rate near
zero.  Ambiguous names (``get``, ``execute``, ``close``...) stay
unbound — a documented blind spot (COVERAGE.md).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import callgraph
from .engine import FileInfo, dotted_name as _dotted

MAIN = "main"
ANY = "any"   # gc callbacks: whichever thread triggers the collection

#: how many call edges a context (or a transitive lock acquisition)
#: propagates through; chains deeper than this are beyond what the
#: unique-name resolver stays precise for
MAX_CONTEXT_DEPTH = 12

_EXECUTOR_CTORS = {"ThreadPoolExecutor", "ProcessPoolExecutor"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
#: worker-pool wrapper classes whose internal executor prefix is fixed
_POOL_CLASSES = {"WorkerPool": "work-pool"}
#: obj-attr call names never worth binding even when globally unique —
#: stdlib/vendor surface that would otherwise alias package methods
_OBJ_BIND_STOPLIST = {
    "append", "add", "discard", "remove", "pop", "update", "extend",
    "get", "put", "items", "keys", "values", "join", "split", "read",
    "write", "result", "set", "clear", "copy", "submit", "encode",
    "decode", "hex", "wait", "acquire", "release", "shutdown",
}


# ---------------------------------------------------------------------------
# per-file summary dataclasses (JSON round-trip for the --changed cache)
# ---------------------------------------------------------------------------

@dataclass
class ConcFunc:
    context: str
    line: int
    cls: str = ""
    # [{"owner": cls|"<module>", "field": str, "line": int}]
    writes: List[dict] = field(default_factory=list)
    # [{"lock": token, "line": int, "held": [token, ...]}]
    acquires: List[dict] = field(default_factory=list)
    # call descriptor (name/mod/self/obj) + {"held": [token, ...]}
    calls: List[dict] = field(default_factory=list)
    # [{"target": descriptor|None, "ctx": label, "line": int}]
    roots: List[dict] = field(default_factory=list)
    # [{"api": str, "line": int}]
    affine: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"context": self.context, "line": self.line,
                "cls": self.cls, "writes": self.writes,
                "acquires": self.acquires, "calls": self.calls,
                "roots": self.roots, "affine": self.affine}

    @classmethod
    def from_json(cls, d: dict) -> "ConcFunc":
        return cls(context=d["context"], line=d["line"],
                   cls=d.get("cls", ""), writes=list(d["writes"]),
                   acquires=list(d["acquires"]), calls=list(d["calls"]),
                   roots=list(d["roots"]), affine=list(d["affine"]))


@dataclass
class FileConc:
    funcs: List[ConcFunc] = field(default_factory=list)
    # class -> [raw dotted base names]
    bases: Dict[str, List[str]] = field(default_factory=dict)
    # class -> def lineno (for class-level confinement pragmas)
    classes: Dict[str, int] = field(default_factory=dict)
    # "Cls.field" | "field" -> [lock_token, decl_line]
    guards: Dict[str, list] = field(default_factory=dict)
    # declared lock attributes: "Cls.attr" | "attr" -> decl_line
    locks: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"funcs": [f.to_json() for f in self.funcs],
                "bases": self.bases, "classes": self.classes,
                "guards": self.guards, "locks": self.locks}

    @classmethod
    def from_json(cls, d: dict) -> "FileConc":
        return cls(funcs=[ConcFunc.from_json(f) for f in d["funcs"]],
                   bases=dict(d["bases"]), classes=dict(d["classes"]),
                   guards=dict(d["guards"]), locks=dict(d["locks"]))


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

def _last_seg(dotted: str) -> str:
    return dotted.rpartition(".")[2]


def _lock_ctor_of(node: ast.AST, imports) -> bool:
    """Is this expression a threading.Lock()/RLock()/... construction
    (possibly wrapped in ``lockdep.register_lock(threading.Lock(), ...)``)?"""
    if not isinstance(node, ast.Call):
        return False
    target = imports.resolve_call(node.func)
    if target is not None:
        if _last_seg(target) == "register_lock" and node.args:
            return _lock_ctor_of(node.args[0], imports)
        if _last_seg(target) in _LOCK_CTORS and "threading" in target:
            return True
    # unresolved attribute spellings like `_threading.Lock()` where the
    # alias map missed: fall back on the ctor name itself
    name = None
    if isinstance(node.func, ast.Attribute):
        name = node.func.attr
    elif isinstance(node.func, ast.Name):
        name = node.func.id
    if name == "register_lock" and node.args:
        return _lock_ctor_of(node.args[0], imports)
    return name in _LOCK_CTORS


def _executor_prefix_of(node: ast.AST, imports) -> Optional[str]:
    """thread_name_prefix of a ThreadPoolExecutor(...) construction (or
    the fixed prefix of a known pool wrapper like WorkerPool)."""
    if not isinstance(node, ast.Call):
        return None
    name = None
    target = imports.resolve_call(node.func)
    if target is not None:
        name = _last_seg(target)
    elif isinstance(node.func, ast.Name):
        name = node.func.id
    elif isinstance(node.func, ast.Attribute):
        name = node.func.attr
    if name in _POOL_CLASSES:
        return _POOL_CLASSES[name]
    if name not in _EXECUTOR_CTORS:
        return None
    for kw in node.keywords:
        if kw.arg == "thread_name_prefix" and \
                isinstance(kw.value, ast.Constant) and \
                isinstance(kw.value.value, str):
            return kw.value.value
    return "pool"


class _FuncConc:
    """One function's concurrency summary (shallow body — nested defs
    are their own summaries, but they share the enclosing class for
    ``self`` attribution: closures over self are common worker bodies)."""

    _MUTATING = {
        "add", "discard", "remove", "pop", "popitem", "clear", "update",
        "append", "extend", "insert", "setdefault", "appendleft",
    }
    _LTXROOT_MUTATORS = {
        "commit_pending_sql", "stage_sealed", "clear_pending",
        "note_bucket_applied", "load_sql_ahead", "enable_bucket_reads",
    }
    _SQLITE_CONN_BASES = {"conn", "_conn"}
    _SQLITE_CURSOR_BASES = {"db", "database", "_db"}

    def __init__(self, info: FileInfo, imports, context: str,
                 cls: Optional[str], node, attr_prefix: Dict[str, str],
                 method_prefix: Dict[str, str]):
        self.info = info
        self.imports = imports
        self.cls = cls or ""
        self.node = node
        self.attr_prefix = attr_prefix
        self.method_prefix = method_prefix
        self.out = ConcFunc(context=context,
                            line=getattr(node, "lineno", 1),
                            cls=self.cls)
        self.held: List[str] = []
        self.globals_decl: Set[str] = set()
        self.is_init = context.rpartition(".")[2] == "__init__"
        self.is_module = context == "<module>"

    def scan(self) -> ConcFunc:
        body = self.node.body if not self.is_module else self.node
        for n in self.globals_of(body):
            self.globals_decl.update(n.names)
        for stmt in body:
            self._walk(stmt)
        return self.out

    @staticmethod
    def globals_of(body):
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Global):
                    yield n

    # -- traversal (skips nested defs; tracks the with-lock stack) ----------

    def _walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, ast.With):
            pushed = 0
            for item in node.items:
                self._walk(item.context_expr)
                tok = self._lock_token(item.context_expr)
                if tok is not None:
                    self.out.acquires.append(
                        {"lock": tok, "line": node.lineno,
                         "held": list(self.held)})
                    self.held.append(tok)
                    pushed += 1
            for stmt in node.body:
                self._walk(stmt)
            for _ in range(pushed):
                self.held.pop()
            return
        self._inspect(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _lock_token(self, expr: ast.AST) -> Optional[str]:
        d = _dotted(expr)
        if d is None:
            return None
        name = _last_seg(d)
        if "lock" in name.lower() or "mutex" in name.lower():
            return d
        return None

    # -- node inspection -----------------------------------------------------

    def _inspect(self, node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._note_write(node, t)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._note_write(node, node.target)
        elif isinstance(node, ast.AugAssign):
            self._note_write(node, node.target)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                self._note_write(node, t)
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self._MUTATING:
                self._note_write(node, node.func.value)
            self._note_call(node)

    def _note_write(self, node: ast.AST, target: ast.AST) -> None:
        if self.is_init or self.is_module:
            return  # construction happens-before sharing
        if isinstance(target, ast.Subscript):
            target = target.value
        d = _dotted(target)
        if d is None:
            return
        if d.startswith("self.") and "." not in d[len("self."):]:
            f = d[len("self."):]
            owner = self.cls or "<module>"
        elif "." not in d and d in self.globals_decl:
            f, owner = d, "<module>"
        else:
            return
        self.out.writes.append({"owner": owner, "field": f,
                                "line": node.lineno})

    def _note_call(self, call: ast.Call) -> None:
        func = call.func
        d = self._describe_call(call)
        if d is not None:
            d["held"] = list(self.held)
            self.out.calls.append(d)
        if isinstance(func, ast.Attribute):
            self._note_attr_roots(call, func)
            self._note_affine(call, func)
        target = self.imports.resolve_call(func)
        if target is not None and _last_seg(target) == "Thread" and \
                "threading" in target:
            self._note_thread_root(call)
        if target is not None and (
                target.startswith("jax.") or target == "jax"):
            self.out.affine.append({"api": "jax-device",
                                    "line": call.lineno})

    def _note_attr_roots(self, call: ast.Call,
                         func: ast.Attribute) -> None:
        attr = func.attr
        if attr == "submit" and call.args:
            prefix = self._submit_prefix(func.value)
            ctx = f"worker:{prefix}"
            self.out.roots.append(
                {"target": self._describe_ref(call.args[0]),
                 "ctx": ctx, "line": call.lineno})
        elif attr == "append":
            d = _dotted(func.value)
            if d is not None and _last_seg(d) == "callbacks" and \
                    d.startswith("gc") and call.args:
                self.out.roots.append(
                    {"target": self._describe_ref(call.args[0]),
                     "ctx": ANY, "line": call.lineno})
        elif attr == "async_wait" and call.args:
            # VirtualTimer callbacks fire on the crank (main) thread
            self.out.roots.append(
                {"target": self._describe_ref(call.args[0]),
                 "ctx": MAIN, "line": call.lineno})
        elif attr == "Thread":
            pass  # handled via resolve_call in _note_call

    def _note_thread_root(self, call: ast.Call) -> None:
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = self._describe_ref(kw.value)
        label = None
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                label = kw.value.value
        if label is None:
            label = (target or {}).get("name", "?")
        self.out.roots.append({"target": target,
                               "ctx": f"thread:{label}",
                               "line": call.lineno})

    def _submit_prefix(self, base: ast.AST) -> str:
        if isinstance(base, ast.Call):
            # lazy factory: self._tails().submit(...)
            m = None
            if isinstance(base.func, ast.Attribute):
                m = base.func.attr
            elif isinstance(base.func, ast.Name):
                m = base.func.id
            if m is not None and m in self.method_prefix:
                return self.method_prefix[m]
            return "?"
        d = _dotted(base)
        if d is None:
            return "?"
        name = _last_seg(d)
        if name in self.attr_prefix:
            return self.attr_prefix[name]
        if "pool" in name.lower():
            return "work-pool"
        return "?"

    def _note_affine(self, call: ast.Call, func: ast.Attribute) -> None:
        attr = func.attr
        base = _dotted(func.value)
        base_name = _last_seg(base) if base else ""
        if attr in ("execute", "executemany", "executescript",
                    "commit", "rollback", "cursor") and \
                base_name in self._SQLITE_CONN_BASES:
            self.out.affine.append({"api": "sqlite-conn",
                                    "line": call.lineno})
        elif attr == "cursor" and base_name in self._SQLITE_CURSOR_BASES:
            self.out.affine.append({"api": "sqlite-cursor",
                                    "line": call.lineno})
        elif attr in self._LTXROOT_MUTATORS:
            self.out.affine.append({"api": "ltxroot-mutate",
                                    "line": call.lineno})
        elif attr == "block_until_ready":
            self.out.affine.append({"api": "jax-device",
                                    "line": call.lineno})

    # -- call / reference descriptors ---------------------------------------

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
                return {"name": func.attr, "self": self.cls,
                        "line": call.lineno}
            mod = None
            if base is not None:
                mod = self.imports.mod_alias.get(base)
                if mod is None and base in self.imports.module_member:
                    pmod, member = self.imports.module_member[base]
                    mod = f"{pmod}.{member}" if pmod else member
            if mod is not None:
                return {"mod": mod, "name": func.attr,
                        "line": call.lineno}
            # unique-name (CHA-lite) candidate: bound at model time iff
            # exactly one package function carries this name
            if func.attr in _OBJ_BIND_STOPLIST or \
                    func.attr.startswith("__"):
                return None
            return {"name": func.attr, "obj": 1, "line": call.lineno}
        return None

    def _describe_ref(self, expr: ast.AST) -> Optional[dict]:
        """A function REFERENCE (submit/Thread/callback target)."""
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.imports.module_member:
                mod, member = self.imports.module_member[name]
                return {"mod": mod, "name": member}
            return {"name": name}
        if isinstance(expr, ast.Attribute):
            base = _dotted(expr.value)
            if base == "self":
                return {"name": expr.attr, "self": self.cls}
            if base is not None:
                mod = self.imports.mod_alias.get(base)
                if mod is None and base in self.imports.module_member:
                    pmod, member = self.imports.module_member[base]
                    mod = f"{pmod}.{member}" if pmod else member
                if mod is not None:
                    return {"mod": mod, "name": expr.attr}
            return {"name": expr.attr, "obj": 1}
        return None  # lambda / computed target: documented blind spot


class _FileConcScanner(ast.NodeVisitor):
    def __init__(self, info: FileInfo):
        self.info = info
        self.imports = callgraph._Imports(info)
        self.out = FileConc()
        self.stack: List[str] = []
        self.cls_stack: List[str] = []
        # executor construction maps (pass 1)
        self.attr_prefix: Dict[str, str] = {}
        self.method_prefix: Dict[str, str] = {}
        self._collect_file_facts()

    # -- pass 1: executors, locks, guards, classes --------------------------

    def _collect_file_facts(self) -> None:
        cls_of: Dict[int, str] = {}
        meth_of: Dict[int, str] = {}
        for node in ast.walk(self.info.tree):
            if isinstance(node, ast.ClassDef):
                self.out.classes[node.name] = node.lineno
                self.out.bases[node.name] = [
                    b for b in (_dotted(x) for x in node.bases)
                    if b is not None]
                for sub in ast.walk(node):
                    if hasattr(sub, "lineno"):
                        cls_of.setdefault(sub.lineno, node.name)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                for sub in ast.walk(node):
                    if hasattr(sub, "lineno"):
                        meth_of.setdefault(sub.lineno, node.name)
        for node in ast.walk(self.info.tree):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
                value = node.value
            else:
                continue
            prefix = _executor_prefix_of(value, self.imports)
            is_lock = value is not None and \
                _lock_ctor_of(value, self.imports)
            guard = self._guard_at(node)
            if prefix is None and not is_lock and guard is None:
                continue
            cls = cls_of.get(node.lineno)
            for t in targets:
                d = _dotted(t)
                if d is None:
                    continue
                name = d[len("self."):] if d.startswith("self.") else d
                if "." in name:
                    continue
                if prefix is not None:
                    self.attr_prefix[name] = prefix
                    meth = meth_of.get(node.lineno)
                    if meth is not None:
                        self.method_prefix[meth] = prefix
                qual = f"{cls}.{name}" if cls and \
                    d.startswith("self.") else name
                if is_lock:
                    self.out.locks[qual] = node.lineno
                if guard is not None:
                    self.out.guards[qual] = [guard, node.lineno]

    def _guard_at(self, node: ast.AST) -> Optional[str]:
        lock = self.info.guards.get(node.lineno)
        if lock is None and getattr(node, "end_lineno", None):
            for ln in range(node.lineno, node.end_lineno + 1):
                if ln in self.info.guards:
                    return self.info.guards[ln]
        return lock

    # -- pass 2: per-function detail ----------------------------------------

    def scan(self) -> FileConc:
        # module-level pseudo-function: calls + roots at import time
        mod_stmts = [s for s in self.info.tree.body
                     if not isinstance(s, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))]
        mod = _FuncConc(self.info, self.imports, "<module>", None,
                        mod_stmts, self.attr_prefix, self.method_prefix)
        for stmt in mod_stmts:
            mod._walk(stmt)
        self.out.funcs.append(mod.out)
        self.visit(self.info.tree)
        return self.out

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
        self.out.funcs.append(_FuncConc(
            self.info, self.imports, context, cls, node,
            self.attr_prefix, self.method_prefix).scan())
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def summarize_conc(info: FileInfo) -> FileConc:
    """The concurrency summary of one parsed file."""
    return _FileConcScanner(info).scan()


# ---------------------------------------------------------------------------
# whole-program model (rebuilt every run over whichever summaries exist)
# ---------------------------------------------------------------------------

@dataclass
class Model:
    funcs: Dict[str, ConcFunc] = field(default_factory=dict)
    path_of: Dict[str, str] = field(default_factory=dict)
    # caller key -> [(callee key, line, frozenset(qualified held))]
    edges: Dict[str, List[Tuple[str, int, frozenset]]] = \
        field(default_factory=dict)
    rev: Dict[str, List[str]] = field(default_factory=dict)
    contexts: Dict[str, Set[str]] = field(default_factory=dict)
    root_targets: Dict[str, Set[str]] = field(default_factory=dict)
    # inventory: [{"ctx", "file", "line", "target", "resolved"}]
    roots: List[dict] = field(default_factory=list)
    # qualified locks provably held on entry from EVERY resolved caller
    held_entry: Dict[str, Set[str]] = field(default_factory=dict)
    # transitive acquisitions: key -> {qlock: (file, line, [chain ctxs])}
    acq_trans: Dict[str, Dict[str, tuple]] = field(default_factory=dict)
    conc: Dict[str, FileConc] = field(default_factory=dict)
    # lock attr name -> [qualified ids] across the package
    lock_index: Dict[str, List[str]] = field(default_factory=dict)

    def qualify_lock(self, token: str, path: str, cls: str) -> str:
        """Lock identity for an acquisition token seen in ``path``
        inside class ``cls``: ``self.X`` binds to this class's
        declaration, a bare name to the module's, and a deep attribute
        chain (``bm._gc_lock``) through the package-wide declaration
        map when the attribute name is unique — the cross-file
        resolution v1 lacked."""
        name = _last_seg(token)
        if token.startswith("self."):
            rest = token[len("self."):]
            if "." not in rest:
                return f"{path}::{cls}.{rest}" if cls \
                    else f"{path}::{rest}"
            # self.a.b._lock: fall through to the unique-name map
        elif "." not in token:
            fc = self.conc.get(path)
            if fc is not None and cls and f"{cls}.{token}" in fc.locks:
                return f"{path}::{cls}.{token}"
            return f"{path}::{token}"
        ids = self.lock_index.get(name, [])
        if len(ids) == 1:
            return ids[0]
        return f"{path}::~{name}"


def _class_closure(conc: Dict[str, FileConc]) -> Dict[str, Set[str]]:
    """class name -> transitive base-name closure (simple-name match —
    one package, collisions acceptable)."""
    direct: Dict[str, Set[str]] = {}
    for fc in conc.values():
        for cls, bases in fc.bases.items():
            direct.setdefault(cls, set()).update(
                _last_seg(b) for b in bases)
    closure: Dict[str, Set[str]] = {}

    def expand(cls: str, seen: Set[str]) -> Set[str]:
        if cls in closure:
            return closure[cls]
        if cls in seen:
            return set()
        seen.add(cls)
        out = set(direct.get(cls, ()))
        for b in list(out):
            out |= expand(b, seen)
        closure[cls] = out
        return out

    for cls in direct:
        expand(cls, set())
    return closure


def build_model(conc: Dict[str, FileConc]) -> Model:
    m = Model(conc=conc)
    summaries = {path: fc.funcs for path, fc in conc.items()}
    module_files = {callgraph.module_of(p): p for p in summaries}
    module_level, methods, any_method = \
        callgraph._index_functions(summaries)

    # unique-name index for obj-attr binding: methods and module-level
    # functions only (never nested defs)
    name_index: Dict[str, List[str]] = {}
    for path, funcs in summaries.items():
        for f in funcs:
            parts = f.context.split(".")
            if len(parts) > 2 or f.context == "<module>":
                continue
            name_index.setdefault(parts[-1], []).append(
                f"{path}::{f.context}")

    for path, fc in conc.items():
        for qual, line in fc.locks.items():
            m.lock_index.setdefault(_last_seg(qual), []).append(
                f"{path}::{qual}")
    for ids in m.lock_index.values():
        ids.sort()

    def bind(call: dict, path: str) -> List[str]:
        if call.get("obj"):
            cands = name_index.get(call["name"], ())
            return list(cands) if len(cands) == 1 else []
        return callgraph._bind(call, path, module_files, module_level,
                               methods, any_method)

    # -- edges ---------------------------------------------------------------
    for path in sorted(summaries):
        fc = conc[path]
        for f in fc.funcs:
            key = f"{path}::{f.context}"
            m.funcs[key] = f
            m.path_of[key] = path
            out: List[Tuple[str, int, frozenset]] = []
            for call in f.calls:
                held = frozenset()
                if call.get("held"):
                    held = frozenset(
                        m.qualify_lock(t, path, f.cls)
                        for t in call["held"])
                for callee in bind(call, path):
                    out.append((callee, call["line"], held))
            m.edges[key] = out
    for caller, edges in m.edges.items():
        for callee, _line, _held in edges:
            m.rev.setdefault(callee, []).append(caller)

    # -- thread roots --------------------------------------------------------
    closure = _class_closure(conc)
    for path in sorted(summaries):
        for f in conc[path].funcs:
            for r in f.roots:
                keys: List[str] = []
                tgt = r.get("target")
                if tgt is not None:
                    keys = bind(dict(tgt), path)
                    if not keys and "name" in tgt and \
                            "mod" not in tgt:
                        # nested defs (thread bodies defined inline):
                        # last-segment match within the same file
                        suffix = "." + tgt["name"]
                        cands = [k for k in m.funcs
                                 if m.path_of[k] == path
                                 and k.endswith(suffix)]
                        if len(cands) == 1:
                            keys = cands
                for key in keys:
                    m.root_targets.setdefault(key, set()).add(r["ctx"])
                m.roots.append({
                    "ctx": r["ctx"], "file": path, "line": r["line"],
                    "target": (tgt or {}).get("name", "<dynamic>"),
                    "resolved": sorted(keys)})
    # ThreadedWork subclasses: on_io runs on the work pool even when the
    # submit site's target is unresolvable across files
    for path in sorted(summaries):
        for cls in conc[path].bases:
            chain = {cls} | closure.get(cls, set())
            if "ThreadedWork" in chain:
                key = methods.get((path, cls, "on_io"))
                if key is not None:
                    m.root_targets.setdefault(key, set()).add(
                        "worker:work-pool")
                    m.roots.append({
                        "ctx": "worker:work-pool", "file": path,
                        "line": m.funcs[key].line,
                        "target": f"{cls}.on_io", "resolved": [key]})
    m.roots.sort(key=lambda r: (r["file"], r["line"], r["ctx"]))

    # -- context propagation (caller -> callee, to fixpoint) -----------------
    incoming: Dict[str, int] = {}
    for caller, edges in m.edges.items():
        for callee, _line, _held in edges:
            incoming[callee] = incoming.get(callee, 0) + 1
    contexts: Dict[str, Set[str]] = {k: set() for k in m.funcs}
    for key, ctxs in m.root_targets.items():
        if key in contexts:
            contexts[key] |= ctxs
    for key in m.funcs:
        if not incoming.get(key) and key not in m.root_targets:
            contexts[key].add(MAIN)
    frontier = [k for k in sorted(contexts) if contexts[k]]
    depth = 0
    while frontier and depth < MAX_CONTEXT_DEPTH:
        depth += 1
        nxt: List[str] = []
        for key in frontier:
            for callee, _line, _held in m.edges.get(key, ()):
                before = len(contexts[callee])
                contexts[callee] |= contexts[key]
                if len(contexts[callee]) != before:
                    nxt.append(callee)
        frontier = sorted(set(nxt))
    m.contexts = contexts

    # -- held-at-entry (intersection over all resolved callers) -------------
    TOP = None  # lattice top: "every lock" until a caller constrains it
    held: Dict[str, Optional[Set[str]]] = {}
    for key in m.funcs:
        held[key] = TOP if incoming.get(key) else set()
    for key in m.root_targets:
        held[key] = set()  # a thread root starts with nothing held
    for _ in range(MAX_CONTEXT_DEPTH):
        changed = False
        for callee in sorted(m.rev):
            if held.get(callee) == set():
                continue
            acc: Optional[Set[str]] = TOP
            for caller in m.rev[callee]:
                for ckey, _line, site_held in m.edges.get(caller, ()):
                    if ckey != callee:
                        continue
                    h = set(site_held)
                    if held.get(caller) not in (TOP, None):
                        h |= held[caller]
                    acc = h if acc is TOP else (acc & h)
            if acc is TOP:
                acc = set()
            if held.get(callee) in (TOP, None) or held[callee] != acc:
                if held[callee] is TOP or held[callee] is None or \
                        acc != held[callee]:
                    held[callee] = acc
                    changed = True
        if not changed:
            break
    m.held_entry = {k: (v if v not in (TOP, None) else set())
                    for k, v in held.items()}

    # -- transitive lock acquisitions (callee -> caller, depth-bounded) -----
    acq: Dict[str, Dict[str, tuple]] = {}
    for key, f in m.funcs.items():
        path = m.path_of[key]
        own: Dict[str, tuple] = {}
        for a in f.acquires:
            q = m.qualify_lock(a["lock"], path, f.cls)
            own.setdefault(q, (path, a["line"], [f.context]))
        acq[key] = own
    for _ in range(MAX_CONTEXT_DEPTH // 2):
        changed = False
        for caller in sorted(m.edges):
            mine = acq[caller]
            for callee, _line, _held in m.edges[caller]:
                for q, wit in acq.get(callee, {}).items():
                    if q not in mine:
                        mine[q] = (wit[0], wit[1],
                                   [m.funcs[caller].context] + wit[2])
                        changed = True
        if not changed:
            break
    m.acq_trans = acq
    return m
