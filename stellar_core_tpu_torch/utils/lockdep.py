"""Runtime lockdep witness — the dynamic half of detlint v3's
concurrency layer (tools/lint/concurrency.py is the static half).

``LOCKDEP=1`` in the environment turns every ``register_lock``-ed lock
into a witness wrapper that records the process-wide lock acquisition
ORDER graph and fails fast (raises) the moment two locks are ever taken
in opposite orders — the runtime analogue of ``conc-lock-cycle``, but
over the orders that actually happened instead of the orders the call
graph can prove possible.  ``guard_fields(obj)`` additionally installs
assert-held write hooks generated from the SAME ``# guarded-by:``
annotations the static rule reads: a guarded field assigned without its
annotated lock held by the current thread raises ``GuardViolation``.

Cost model
----------
Disabled (the default): ``register_lock`` returns the RAW lock object
and ``guard_fields`` is a no-op — zero per-acquire cost, better than
the one-attr-check budget.  Enabled: one thread-local stack push/pop
plus a set lookup per acquire on known orders; graph mutation only on
the FIRST occurrence of a new (outer, inner) pair.  The overhead gate
lives in tests/test_lockdep.py and tools/verify_green.py
--lockdep-smoke.

Known relaxations (mirrored in COVERAGE.md):
- reads of guarded fields are UNCHECKED — the close pipeline reads
  ``_hold``/``stats`` lock-free by design (benign-stale);
- module-level guarded globals (native/__init__.py ``_lib``) cannot be
  descriptor-wrapped — only their lock ORDER is witnessed;
- interior mutation (``d[k] = v`` on a guarded dict) does not pass
  through ``__set__`` — only rebinding the attribute is checked.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

LOCKDEP_ENABLED = os.environ.get("LOCKDEP", "0") == "1"

_GUARD_COMMENT = "# guarded-by:"


class LockOrderInversion(AssertionError):
    """Two witnessed locks were acquired in opposite orders."""


class GuardViolation(AssertionError):
    """A guarded field was written without its annotated lock held."""


_tls = threading.local()
_graph_lock = threading.Lock()
# outer lock name -> set of lock names acquired while holding it
_edges: Dict[str, Set[str]] = {}           # guarded-by: _graph_lock
# (outer, inner) -> (thread name, held-stack snapshot) first witness
_witness: Dict[Tuple[str, str], tuple] = {}  # guarded-by: _graph_lock
_stats = {
    "locks": 0, "acquires": 0, "edges": 0,
    "inversions": 0, "guard_checks": 0, "guard_violations": 0,
}


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _reachable(src: str, dst: str) -> Optional[List[str]]:
    """A path src -> ... -> dst in the edge graph (holding _graph_lock),
    or None."""
    seen = {src}
    frontier = [(src, [src])]
    while frontier:
        node, path = frontier.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                frontier.append((nxt, path + [nxt]))
    return None


class WitnessLock:
    """Order-witnessing wrapper around a threading.Lock/RLock.

    Re-entrant acquires of the SAME witness name push/pop the held
    stack without re-recording edges, so wrapped RLocks keep their
    semantics and self-edges never appear in the graph."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def held_by_me(self) -> bool:
        return self.name in _stack()

    def _note_acquired(self) -> None:
        # the slow-path twin of __enter__'s inline bookkeeping (plain
        # acquire() calls and the edge-recording loop both land here)
        st = _stack()
        _stats["acquires"] += 1
        if self.name not in st:
            for outer in st:
                self._note_edge(outer, self.name)
        st.append(self.name)

    def _note_edge(self, outer: str, inner: str) -> None:
        if outer == inner:
            return
        succ = _edges.get(outer)
        if succ is not None and inner in succ:
            return  # known-good order: the per-acquire fast path
        with _graph_lock:
            succ = _edges.setdefault(outer, set())
            if inner in succ:
                return
            back = _reachable(inner, outer)
            here = (threading.current_thread().name, list(_stack()))
            if back is not None:
                _stats["inversions"] += 1
                prior = " -> ".join(back)
                wit = _witness.get((back[0], back[1]))
                prior_at = f" (first witnessed on thread " \
                           f"{wit[0]!r}, held {wit[1]})" if wit else ""
                raise LockOrderInversion(
                    f"lock order inversion: acquiring {inner!r} while "
                    f"holding {outer!r}, but the established order is "
                    f"{prior}{prior_at}; current thread "
                    f"{here[0]!r} holds {here[1]}")
            succ.add(inner)
            _witness[(outer, inner)] = here
            _stats["edges"] += 1

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        st = _stack()
        # pop the most recent occurrence (re-entrant releases unwind in
        # LIFO order); a foreign release order still unwinds correctly
        # because release() precedes the underlying lock's own error
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self.name:
                del st[i]
                break
        self._lock.release()

    def __enter__(self) -> "WitnessLock":
        # the hot path: inlined bookkeeping, no helper frames.  The
        # common case (outermost acquire, empty held stack) touches one
        # thread-local attribute, one counter and one list append
        self._lock.acquire()
        try:
            st = _tls.stack
        except AttributeError:
            st = _tls.stack = []
        _stats["acquires"] += 1
        if st and self.name not in st:
            for outer in st:
                self._note_edge(outer, self.name)
        st.append(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        st = _tls.stack
        if st and st[-1] == self.name:
            st.pop()  # LIFO release: the overwhelmingly common case
        else:
            for i in range(len(st) - 1, -1, -1):
                if st[i] == self.name:
                    del st[i]
                    break
        self._lock.release()


def register_lock(lock, name: str):
    """Wrap ``lock`` for order witnessing under LOCKDEP=1; return it
    untouched otherwise (zero steady-state cost when disabled)."""
    if not LOCKDEP_ENABLED:
        return lock
    _stats["locks"] += 1
    return WitnessLock(lock, name)


# ---------------------------------------------------------------------------
# assert-held write hooks from # guarded-by: annotations
# ---------------------------------------------------------------------------

class _GuardedField:
    """Class-level data descriptor enforcing the annotated lock on
    WRITES (reads are unchecked — see the module docstring).  Values
    live in the instance ``__dict__`` under the field's own name, so
    instances created before installation keep working and ``vars()``
    stays truthful."""

    __slots__ = ("field", "lock_attr")

    def __init__(self, field: str, lock_attr: str):
        self.field = field
        self.lock_attr = lock_attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[self.field]
        except KeyError:
            raise AttributeError(self.field) from None

    def __set__(self, obj, value) -> None:
        # hot path: instance-dict probes only, no getattr chains (this
        # runs on every post-init write to a guarded field)
        d = obj.__dict__
        if "_lockdep_enforced" in d:
            lock = d.get(self.lock_attr)
            if type(lock) is WitnessLock:
                _stats["guard_checks"] += 1
                try:
                    st = _tls.stack
                except AttributeError:
                    st = _tls.stack = []
                if lock.name not in st:
                    _stats["guard_violations"] += 1
                    raise GuardViolation(
                        f"write to {type(obj).__name__}."
                        f"{self.field} (guarded-by: "
                        f"{self.lock_attr}) without {lock.name!r} "
                        f"held by thread "
                        f"{threading.current_thread().name!r}")
        d[self.field] = value

    def __delete__(self, obj) -> None:
        self.__set__(obj, None)
        del obj.__dict__[self.field]


def _guard_table(cls) -> Dict[str, str]:
    """field -> lock attr parsed from the class source's
    ``# guarded-by:`` trailing annotations (the same lines detlint
    reads)."""
    import ast
    import inspect
    import textwrap

    try:
        src = textwrap.dedent(inspect.getsource(cls))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return {}
    lines = src.splitlines()
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        lock = None
        for ln in range(node.lineno,
                        (getattr(node, "end_lineno", node.lineno)
                         or node.lineno) + 1):
            if 1 <= ln <= len(lines) and _GUARD_COMMENT in lines[ln - 1]:
                lock = lines[ln - 1].split(_GUARD_COMMENT, 1)[1] \
                    .strip().split()[0]
                break
        if lock is None:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self" and "lock" not in t.attr.lower():
                table[t.attr] = lock
    return table


_installed: Set[type] = set()


def guard_fields(obj) -> None:
    """Arm assert-held write hooks for ``obj``'s annotated fields.

    Call at the END of ``__init__`` (after the lock and every guarded
    field exist): descriptors install once per class, and enforcement
    for THIS instance starts only now — construction writes before the
    call are exempt (happens-before sharing).  No-op unless LOCKDEP=1.
    """
    if not LOCKDEP_ENABLED:
        return
    cls = type(obj)
    if cls not in _installed:
        with _graph_lock:
            if cls not in _installed:
                for fieldname, lock_attr in sorted(
                        _guard_table(cls).items()):
                    setattr(cls, fieldname,
                            _GuardedField(fieldname, lock_attr))
                _installed.add(cls)
    obj.__dict__["_lockdep_enforced"] = True


def stats() -> dict:
    """Witness counters snapshot (the lockdep smoke's zero-violation
    gate reads this)."""
    with _graph_lock:
        out = dict(_stats)
        out["enabled"] = LOCKDEP_ENABLED
        return out


def reset() -> None:
    """Tests only: drop the order graph and counters (NOT the installed
    descriptors — enforcement state is per-instance)."""
    with _graph_lock:
        _edges.clear()
        _witness.clear()
        for k in _stats:
            _stats[k] = 0
