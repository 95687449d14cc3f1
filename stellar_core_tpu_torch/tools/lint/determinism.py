"""Determinism rules (family a): consensus-critical modules must not
read ambient nondeterminism or iterate hash-ordered containers into
anything that serializes, hashes, or tallies.

Rules
-----
det-wallclock     time.*/datetime.now/random.*/uuid.*/os.environ reads in
                  a consensus module (scp/herder/ledger/bucket/
                  transactions/xdr/crypto).  The virtual clock
                  (app.clock / VirtualClock) is the sanctioned time
                  source; seeded random.Random(seed) instances are fine.
                  SANCTIONED instrumentation APIs — utils.tracing.span /
                  utils.tracing.stopwatch / Timer.time_scope — are
                  explicitly exempt: their perf_counter reads live in
                  utils/ (outside the consensus scan) and feed only
                  observability, so adding a span to a consensus module
                  never needs a new baseline entry.
det-unsorted-iter a for-loop / list-comp / generator over an unsorted
                  dict view (.items()/.values()/.keys()) or a set-typed
                  name, in a function that feeds a hash/serialize/tally
                  sink.  Set/dict comprehensions are exempt — their
                  RESULT is order-insensitive.  Wrap the iterable in
                  sorted(...) to fix.
det-float-consensus
                  float division (or float()/round() coercion) touching
                  ledger-value names (fee/price/amount/balance/stroop/
                  coin) in a consensus module — consensus math must be
                  exact int (the reference's uint128 discipline).
det-jit-host-effect
                  host-side Python effects (print/open/os/time/random/
                  np.random/environ) inside a jax.jit-decorated function
                  in ops/ — traced once, silently stale or nondeterministic
                  after compilation caching.
det-telemetry-readback
                  the SCP timeline recorder (scp/timeline.py) must stay
                  WRITE-ONLY from consensus code: a ``.timeline``
                  reference may be aliased to a local, guarded on
                  ``.enabled`` / ``is None``, and called as a bare
                  ``.record(...)`` statement — any other use (return,
                  argument, arithmetic, iteration, reading its state)
                  is a data flow from telemetry into consensus and
                  breaks the telemetry-on/off bit-identity contract.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .engine import ContextVisitor, FileInfo, Finding, dotted_name as _dotted

# module -> banned attributes (call or bare attribute access)
_WALLCLOCK_MODS: Dict[str, Set[str]] = {
    "time": {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns", "process_time",
             "process_time_ns", "localtime", "gmtime", "ctime", "asctime"},
    "random": {"random", "randrange", "randint", "choice", "choices",
               "shuffle", "sample", "uniform", "getrandbits", "betavariate",
               "gauss", "normalvariate", "triangular", "expovariate"},
    "uuid": {"uuid1", "uuid3", "uuid4", "uuid5", "getnode"},
    "os": {"getenv", "environ"},
}
_DATETIME_METHODS = {"now", "utcnow", "today"}

# sanctioned instrumentation APIs: calls through these never produce
# det-wallclock findings, whatever future rule tightening adds to the
# banned table — instrumentation must stay cheap to add (the flight
# recorder's whole point).  Matching is on the resolved call target:
# "...utils.tracing.span", bare "span"/"stopwatch" from-imported from
# the tracing module, and any ".time_scope" metric-timer scope.
_SANCTIONED_SUFFIXES = (
    "utils.tracing.span", "utils.tracing.stopwatch",
    "tracing.span", "tracing.stopwatch",
)
_SANCTIONED_ATTRS = {"time_scope"}


def is_sanctioned_timing_call(target: Optional[str]) -> bool:
    if not target:
        return False
    if target.endswith(_SANCTIONED_SUFFIXES):
        return True
    return target.rpartition(".")[2] in _SANCTIONED_ATTRS

# call names whose enclosing function marks iteration order as
# consensus-visible: hashing/serialization, federated tallies, and
# order-carried set mutation (.add in a loop whose pick depends on what
# was added so far — the nomination round-leader bug shape)
_SINKS_EXACT = {
    "sha256", "sha512", "blake2b", "digest", "hexdigest", "tally",
    "federated_accept", "federated_ratify", "is_quorum", "is_v_blocking",
    "combine_candidates", "emit_envelope", "serialize", "add", "execute",
    "sign", "add_batch",
}
_SINKS_SUFFIX = ("hash", "encode")

_LEDGER_VALUE_RE = ("fee", "price", "amount", "balance", "stroop", "coin")

_JIT_EFFECT_MODS = {"os", "time", "random"}
_JIT_EFFECT_CALLS = {"print", "open", "input"}


class _ImportMap:
    """Resolves local alias -> canonical module / member names."""

    def __init__(self, tree: ast.AST):
        self.mod_alias: Dict[str, str] = {}   # alias -> module name
        self.member: Dict[str, str] = {}      # name -> "module.member"
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_alias[a.asname or a.name] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.member[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve_call(self, func: ast.AST) -> Optional[str]:
        """Canonical 'module.attr' for a call target, if resolvable."""
        if isinstance(func, ast.Attribute):
            base = _dotted(func.value)
            if base is None:
                return None
            mod = self.mod_alias.get(base, base)
            return f"{mod}.{func.attr}"
        if isinstance(func, ast.Name):
            return self.member.get(func.id, func.id)
        return None


# ---------------------------------------------------------------------------
# det-wallclock
# ---------------------------------------------------------------------------

class _WallclockVisitor(ContextVisitor):
    def __init__(self, info: FileInfo, imports: _ImportMap):
        super().__init__(info)
        self.imports = imports

    def _check_target(self, node: ast.AST, target: Optional[str]) -> None:
        if not target or "." not in target:
            # from-import resolution maps bare names to module.member
            return
        if is_sanctioned_timing_call(target):
            return
        mod, _, attr = target.rpartition(".")
        # datetime.datetime.now / date.today
        if mod in ("datetime.datetime", "datetime.date", "datetime") and \
                attr in _DATETIME_METHODS:
            self.add("det-wallclock", node,
                     f"wall-clock read {target}() in consensus module "
                     "(use the virtual clock)")
            return
        banned = _WALLCLOCK_MODS.get(mod)
        if banned and attr in banned:
            what = ("ambient environment read" if mod == "os"
                    else "unseeded RNG" if mod == "random"
                    else "wall-clock read")
            self.add("det-wallclock", node,
                     f"{what} {target} in consensus module")

    def visit_Call(self, node: ast.Call) -> None:
        self._check_target(node, self.imports.resolve_call(node.func))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # bare os.environ access (subscript, .get, iteration ...)
        base = _dotted(node.value)
        if base is not None:
            mod = self.imports.mod_alias.get(base, base)
            if mod == "os" and node.attr == "environ":
                self.add("det-wallclock", node,
                         "ambient environment read os.environ in "
                         "consensus module")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# det-unsorted-iter
# ---------------------------------------------------------------------------

_ITER_UNWRAP = {"list", "tuple", "enumerate", "reversed", "iter"}

# consumers whose RESULT does not depend on iteration order: a
# comprehension fed straight into one of these is exempt
_ORDER_INSENSITIVE_CONSUMERS = {
    "sorted", "set", "frozenset", "min", "max", "sum", "any", "all",
    "len",
}

_SET_TYPE_NAMES = {"set", "Set", "frozenset", "FrozenSet", "MutableSet"}


def _is_set_expr(node: ast.AST) -> bool:
    return isinstance(node, (ast.Set, ast.SetComp)) or (
        isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset"))


def _set_annotation(ann: Optional[ast.AST]) -> bool:
    """True only when the OUTER type is a set (List[set] is a list)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    name = None
    if isinstance(ann, ast.Name):
        name = ann.id
    elif isinstance(ann, ast.Attribute):
        name = ann.attr
    return name in _SET_TYPE_NAMES


class _FuncScope(ast.NodeVisitor):
    """Names bound to set values.  With ``self_only`` (the class-wide
    pass) only ``self.X`` attribute bindings are collected — a bare
    local in one method says nothing about other methods."""

    def __init__(self, self_only: bool = False):
        self.set_names: Set[str] = set()
        self.self_only = self_only

    def _record(self, target: ast.AST) -> None:
        d = _dotted(target)
        if d is None:
            return
        if self.self_only and not d.startswith("self."):
            return
        self.set_names.add(d)

    def visit_Assign(self, node: ast.Assign) -> None:
        if _is_set_expr(node.value):
            for t in node.targets:
                self._record(t)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if _set_annotation(node.annotation) or (
                node.value is not None and _is_set_expr(node.value)):
            self._record(node.target)
        self.generic_visit(node)

    def visit_arg(self, node: ast.arg) -> None:
        if not self.self_only and _set_annotation(node.annotation):
            self.set_names.add(node.arg)


def _shallow_walk(func):
    """Walk a function's body WITHOUT descending into nested def/class
    bodies — those are visited as their own contexts, and scanning them
    here too would double-report every finding (once per context)."""
    from collections import deque

    todo = deque([func])
    while todo:
        node = todo.popleft()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            todo.append(child)


def _call_names(func) -> Set[str]:
    out: Set[str] = set()
    for node in _shallow_walk(func):
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                out.add(node.func.attr)
            elif isinstance(node.func, ast.Name):
                out.add(node.func.id)
    return out


def _has_sink(names: Set[str]) -> bool:
    for n in names:
        if n in _SINKS_EXACT:
            return True
        low = n.lower()
        if any(low.endswith(s) for s in _SINKS_SUFFIX):
            return True
    return False


def _unwrap_iter(node: ast.AST) -> ast.AST:
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _ITER_UNWRAP and node.args:
        node = node.args[0]
    return node


class _UnsortedIterVisitor(ContextVisitor):
    """Runs per function: collects set-typed names for the whole class
    first (self.X = set() in any method marks self.X)."""

    def __init__(self, info: FileInfo):
        super().__init__(info)
        self.class_sets: List[Set[str]] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        scope = _FuncScope(self_only=True)
        scope.visit(node)
        self.class_sets.append(scope.set_names)
        super().visit_ClassDef(node)
        self.class_sets.pop()

    def _visit_func(self, node) -> None:
        scope = _FuncScope()
        scope.visit(node)
        known_sets = set(scope.set_names)
        for cls in self.class_sets:
            known_sets |= cls
        if _has_sink(_call_names(node)):
            self.stack.append(node.name)
            self._scan_iterations(node, known_sets)
            self.stack.pop()
        # still recurse for nested defs/classes
        ContextVisitor._visit_func(self, node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _scan_iterations(self, func, known_sets: Set[str]) -> None:
        exempt: Set[int] = set()
        for node in _shallow_walk(func):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in _ORDER_INSENSITIVE_CONSUMERS:
                for a in node.args:
                    if isinstance(a, (ast.ListComp, ast.GeneratorExp)):
                        exempt.add(id(a))
        for node in _shallow_walk(func):
            if isinstance(node, ast.For):
                self._check_iter(node.iter, node, known_sets)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
                # Set/DictComp results are order-insensitive: exempt,
                # as is a comprehension fed straight into sorted()/sum()/
                # any()/... whose result ignores order
                if id(node) in exempt:
                    continue
                for gen in node.generators:
                    self._check_iter(gen.iter, node, known_sets)

    def _check_iter(self, it: ast.AST, where: ast.AST,
                    known_sets: Set[str]) -> None:
        it = _unwrap_iter(it)
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "sorted":
            return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("items", "values", "keys") \
                and not it.args:
            self.add("det-unsorted-iter", where,
                     f"iteration over unsorted .{it.func.attr}() view in "
                     "a hash/serialize/tally-feeding function "
                     "(wrap in sorted(...))")
            return
        d = _dotted(it)
        if d is not None and d in known_sets:
            self.add("det-unsorted-iter", where,
                     f"iteration over set '{d}' in a hash/serialize/"
                     "tally-feeding function (wrap in sorted(...))")


# ---------------------------------------------------------------------------
# det-float-consensus
# ---------------------------------------------------------------------------

def _mentions_ledger_value(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name:
            low = name.lower()
            if any(k in low for k in _LEDGER_VALUE_RE):
                return True
    return False


class _FloatVisitor(ContextVisitor):
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Div) and (
                _mentions_ledger_value(node.left)
                or _mentions_ledger_value(node.right)):
            self.add("det-float-consensus", node,
                     "float division on a ledger value (fee/price/amount) "
                     "— use exact int math (//, Fraction, or "
                     "cross-multiplication)")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name) and node.func.id == "float" \
                and node.args and _mentions_ledger_value(node.args[0]):
            self.add("det-float-consensus", node,
                     "float() coercion of a ledger value — consensus "
                     "math must stay exact int")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# det-jit-host-effect
# ---------------------------------------------------------------------------

def _is_jit_decorator(dec: ast.AST) -> bool:
    d = _dotted(dec)
    if d in ("jit", "jax.jit"):
        return True
    if isinstance(dec, ast.Call):
        f = _dotted(dec.func)
        if f in ("jit", "jax.jit"):
            return True
        if f in ("partial", "functools.partial") and dec.args:
            return _dotted(dec.args[0]) in ("jit", "jax.jit")
    return False


class _JitVisitor(ContextVisitor):
    def __init__(self, info: FileInfo, imports: _ImportMap):
        super().__init__(info)
        self.imports = imports

    def _visit_func(self, node) -> None:
        if any(_is_jit_decorator(d) for d in node.decorator_list):
            self.stack.append(node.name)
            self._scan_body(node)
            self.stack.pop()
        ContextVisitor._visit_func(self, node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _scan_body(self, func) -> None:
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                target = self.imports.resolve_call(node.func) or ""
                mod = target.split(".", 1)[0]
                if target in _JIT_EFFECT_CALLS or \
                        mod in _JIT_EFFECT_MODS or \
                        target.startswith(("np.random.", "numpy.random.")):
                    self.add("det-jit-host-effect", node,
                             f"host-side effect '{target}' inside a "
                             "jax.jit-traced kernel (runs once at trace "
                             "time, not per call)")
            elif isinstance(node, ast.Attribute) and \
                    node.attr == "environ":
                base = _dotted(node.value)
                if base and self.imports.mod_alias.get(base, base) == "os":
                    self.add("det-jit-host-effect", node,
                             "os.environ read inside a jax.jit-traced "
                             "kernel (baked in at trace time)")


# ---------------------------------------------------------------------------
# det-telemetry-readback
# ---------------------------------------------------------------------------

class _TelemetryReadback(ContextVisitor):
    """Flag any data flow FROM the slot-timeline recorder INTO
    consensus code.  Allowed shapes (everything the instrumented call
    sites need, nothing more):

      tl = <chain>.timeline          # alias to a local name
      if tl.enabled: ...             # / <chain>.timeline.enabled
      if tl is None / is not None:   # existence guard
      tl.record(...)                 # / <chain>.timeline.record(...)
                                     # as a bare expression statement

    Every other appearance of a timeline reference — returned, passed
    to another call, iterated, subscripted, read for its state — is a
    finding: the recorder must be taint-sink-free."""

    def visit_Module(self, node) -> None:
        self._scan(node)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self._scan(node)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self._scan(node)
        self.stack.pop()
        ContextVisitor._visit_func(self, node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _scan(self, scope) -> None:
        aliases: Set[str] = set()
        for n in _shallow_walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and \
                    isinstance(n.value, ast.Attribute) and \
                    n.value.attr == "timeline":
                aliases.add(n.targets[0].id)

        def ref(n: ast.AST) -> bool:
            return (isinstance(n, ast.Attribute)
                    and n.attr == "timeline") or \
                   (isinstance(n, ast.Name) and n.id in aliases)

        ok_ids: Set[int] = set()
        for n in _shallow_walk(scope):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name) and ref(n.value):
                ok_ids.add(id(n.value))
            elif isinstance(n, ast.Expr) and isinstance(n.value, ast.Call):
                f = n.value.func
                if isinstance(f, ast.Attribute) and f.attr == "record" \
                        and ref(f.value):
                    ok_ids.add(id(f.value))
            elif isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                self._mark_guard(n.test, ref, ok_ids)
        for n in _shallow_walk(scope):
            # Store/Del contexts write INTO the name (aliasing, or
            # installing the recorder attribute) — no data flows OUT
            # of the recorder there
            if isinstance(getattr(n, "ctx", None), (ast.Store, ast.Del)):
                continue
            if ref(n) and id(n) not in ok_ids:
                self.add(
                    "det-telemetry-readback", n,
                    "timeline recorder state must not flow into "
                    "consensus code (allowed: alias, .enabled / "
                    "is-None guard, bare .record(...) statement)")

    @staticmethod
    def _mark_guard(test: ast.AST, ref, ok_ids: Set[int]) -> None:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr == "enabled" \
                    and ref(sub.value):
                ok_ids.add(id(sub.value))
            elif isinstance(sub, ast.Compare) and ref(sub.left) and \
                    all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in sub.ops) and \
                    all(isinstance(c, ast.Constant) and c.value is None
                        for c in sub.comparators):
                ok_ids.add(id(sub.left))


# ---------------------------------------------------------------------------

def check(info: FileInfo) -> List[Finding]:
    findings: List[Finding] = []
    if info.in_consensus():
        imports = _ImportMap(info.tree)
        visitors = [_WallclockVisitor(info, imports),
                    _UnsortedIterVisitor(info),
                    _FloatVisitor(info)]
        if not info.path.endswith("scp/timeline.py"):
            # the recorder module itself is the one legitimate reader
            visitors.append(_TelemetryReadback(info))
        for visitor in visitors:
            visitor.visit(info.tree)
            findings.extend(visitor.findings)
    if info.in_kernels():
        imports = _ImportMap(info.tree)
        v = _JitVisitor(info, imports)
        v.visit(info.tree)
        findings.extend(v.findings)
    return findings
