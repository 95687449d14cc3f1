"""detlint v3 concurrency rules (family c) — whole-program analyses
over the thread-context model (tools/lint/threadmodel.py).

Rules
-----
conc-unguarded-shared   a ``self.``/module attribute written from >= 2
                        inferred thread contexts without a
                        ``# guarded-by:`` annotation.  One finding per
                        writing function (anchored at its first write)
                        so a pragma sits next to the code it excuses.
                        ``__init__``/module-level writes are exempt
                        (construction happens-before sharing), as are
                        fields of classes whose ``class`` line carries
                        a ``# detlint: allow(conc-unguarded-shared)``
                        pragma — the instance-confinement marker for
                        per-task payload objects (each instance touched
                        by one thread at a time, hand-off via queue/
                        future happens-before).
conc-thread-affine-call a thread-affine API (raw sqlite connection,
                        ``db.cursor()`` escape hatch, LedgerTxnRoot
                        non-overlay mutation, JAX device calls) reached
                        from a context outside the API's owner set.
conc-lock-cycle         a cycle in the cross-file lock-order graph:
                        lock identities are package-qualified
                        (``path::Class.attr``) through the declaration
                        map, acquisition edges are collected both
                        lexically (with-stack) and interprocedurally
                        (call under held lock -> callee's transitive
                        acquisitions), and each cycle is reported once
                        with the full acquisition chain.  Two-lock
                        same-file lexical inversions stay with the v1
                        ``lock-order`` rule.

This module also EXONERATES v1 ``lock-unguarded-write`` findings whose
function provably holds the declared lock on entry from every resolved
caller — the interprocedural upgrade of the lexical discipline: callees
of ``ClosePipeline.submit_tail`` no longer need a redundant ``with``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import re

from .engine import FileInfo, Finding
from . import threadmodel
from .threadmodel import ANY, MAIN, FileConc, Model

RULE_SHARED = "conc-unguarded-shared"
RULE_AFFINE = "conc-thread-affine-call"
RULE_CYCLE = "conc-lock-cycle"

#: owner contexts per thread-affine API.  The close tail worker is a
#: first-class owner of the commit-path APIs: in pipelined mode the
#: tail IS the ledger-state writer (ISSUE 13).
AFFINE_OWNERS: Dict[str, Set[str]] = {
    # raw sqlite3.Connection use: only Database's own serialization
    # boundary (main + close tail via Database.execute's _write_lock)
    "sqlite-conn": {MAIN, "worker:close-tail"},
    # db.cursor() escape hatch: commit paths only
    "sqlite-cursor": {MAIN, "worker:close-tail"},
    # LedgerTxnRoot non-overlay mutation
    "ltxroot-mutate": {MAIN, "worker:close-tail"},
    # JAX device dispatch: crank thread + the quorum bridge thread that
    # exists precisely to move device work off the crank
    "jax-device": {MAIN, "thread:_bridge"},
}

_V1_UNGUARDED_RE = re.compile(
    r"write to '([^']+)' \(guarded-by: ([^)]+)\)")


def _fc_guard(fc: FileConc, owner: str, fieldname: str) -> Optional[str]:
    """The declared guard lock for a field, class-qualified first."""
    if owner and owner != "<module>":
        hit = fc.guards.get(f"{owner}.{fieldname}")
        if hit is not None:
            return hit[0]
    hit = fc.guards.get(fieldname)
    return hit[0] if hit is not None else None


def _class_confined(info: Optional[FileInfo], fc: FileConc,
                    owner: str) -> bool:
    """Class-level confinement pragma on the ``class`` line (or the
    line above): every field of the class is instance-confined."""
    if info is None or owner in ("", "<module>"):
        return False
    line = fc.classes.get(owner)
    if line is None:
        return False
    for ln in (line, line - 1):
        rules = info.pragmas.get(ln)
        if rules and (RULE_SHARED in rules or "*" in rules):
            return True
    return False


def _fmt_ctxs(ctxs: Iterable[str]) -> str:
    return "{" + ", ".join(sorted(ctxs)) + "}"


def _short_lock(qlock: str) -> str:
    """'stellar_core_tpu/bucket/bucket_list.py::BucketManager._gc_lock'
    -> 'bucket_list.py::BucketManager._gc_lock' (message brevity)."""
    path, _, name = qlock.partition("::")
    return f"{path.rpartition('/')[2]}::{name}"


# ---------------------------------------------------------------------------
# rule 1: conc-unguarded-shared
# ---------------------------------------------------------------------------

def _check_shared(m: Model, by_path: Dict[str, FileInfo]
                  ) -> List[Finding]:
    # (path, owner, field) -> [(func key, first write line)]
    writers: Dict[Tuple[str, str, str], List[Tuple[str, int]]] = {}
    for key in sorted(m.funcs):
        f = m.funcs[key]
        path = m.path_of[key]
        first: Dict[Tuple[str, str, str], int] = {}
        for w in f.writes:
            fid = (path, w["owner"], w["field"])
            if fid not in first or w["line"] < first[fid]:
                first[fid] = w["line"]
        for fid, line in sorted(first.items()):
            writers.setdefault(fid, []).append((key, line))

    findings: List[Finding] = []
    for fid in sorted(writers):
        path, owner, fieldname = fid
        if "lock" in fieldname.lower() or "mutex" in fieldname.lower():
            continue  # the locks themselves are not guarded data
        fc = m.conc[path]
        if _fc_guard(fc, owner, fieldname) is not None:
            continue  # annotated: the with-lock rules own discipline
        if _class_confined(by_path.get(path), fc, owner):
            continue
        union: Set[str] = set()
        for key, _line in writers[fid]:
            union |= m.contexts.get(key, set())
        multi = len(union - {ANY}) >= 2 or ANY in union
        if not multi:
            continue
        where = owner if owner != "<module>" else "module"
        for key, line in writers[fid]:
            f = m.funcs[key]
            info = by_path.get(path)
            findings.append(Finding(
                rule=RULE_SHARED, file=path, line=line, col=0,
                context=f.context,
                message=(f"'{where}.{fieldname}' is written from "
                         f"thread contexts {_fmt_ctxs(union)} with no "
                         f"'# guarded-by:' annotation"),
                line_text=info.line_text(line) if info else ""))
    return findings


# ---------------------------------------------------------------------------
# rule 2: conc-thread-affine-call
# ---------------------------------------------------------------------------

def _check_affine(m: Model, by_path: Dict[str, FileInfo]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    for key in sorted(m.funcs):
        f = m.funcs[key]
        if not f.affine:
            continue
        path = m.path_of[key]
        ctxs = m.contexts.get(key, set())
        for site in f.affine:
            owners = AFFINE_OWNERS.get(site["api"], set())
            bad = ctxs - owners
            if ANY in ctxs and ANY not in owners:
                bad |= {ANY}
            if not bad:
                continue
            info = by_path.get(path)
            findings.append(Finding(
                rule=RULE_AFFINE, file=path, line=site["line"], col=0,
                context=f.context,
                message=(f"thread-affine API '{site['api']}' (owners "
                         f"{_fmt_ctxs(owners)}) reached from "
                         f"{_fmt_ctxs(bad)}"),
                line_text=(info.line_text(site["line"])
                           if info else "")))
    return findings


# ---------------------------------------------------------------------------
# rule 3: conc-lock-cycle
# ---------------------------------------------------------------------------

def _lock_edges(m: Model) -> Dict[Tuple[str, str], tuple]:
    """(outer qlock, inner qlock) -> first witness
    (file, line, kind, description); deterministic first-wins order."""
    edges: Dict[Tuple[str, str], tuple] = {}
    for key in sorted(m.funcs):
        f = m.funcs[key]
        path = m.path_of[key]
        for a in f.acquires:
            inner = m.qualify_lock(a["lock"], path, f.cls)
            for tok in a["held"]:
                outer = m.qualify_lock(tok, path, f.cls)
                if outer == inner:
                    continue  # RLock re-entry
                edges.setdefault(
                    (outer, inner),
                    (path, a["line"], "lexical",
                     f"{f.context} acquires {_short_lock(inner)} "
                     f"while holding {_short_lock(outer)}"))
    for key in sorted(m.edges):
        f = m.funcs[key]
        path = m.path_of[key]
        for callee, line, held in m.edges[key]:
            if not held:
                continue
            for inner, wit in sorted(m.acq_trans.get(callee, {})
                                     .items()):
                chain = " -> ".join(wit[2])
                for outer in sorted(held):
                    if outer == inner:
                        continue
                    edges.setdefault(
                        (outer, inner),
                        (path, line, "interproc",
                         f"{f.context} holds {_short_lock(outer)} and "
                         f"calls {chain} which acquires "
                         f"{_short_lock(inner)} at {wit[0]}:{wit[1]}"))
    return edges


def _sccs(nodes: Sequence[str],
          succ: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan SCCs, iterative, deterministic order."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(succ.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                u = work[-1][0]
                low[u] = min(low[u], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(sorted(comp))
    return out


def _cycle_path(comp: List[str],
                succ: Dict[str, List[str]]) -> List[str]:
    """One concrete cycle inside an SCC: walk smallest successors from
    the smallest node until revisit."""
    inside = set(comp)
    start = comp[0]
    path = [start]
    seen = {start}
    cur = start
    while True:
        nxt = None
        for w in succ.get(cur, ()):
            if w in inside and w == start and len(path) > 1:
                return path
            if w in inside and w not in seen:
                nxt = w
                break
        if nxt is None:
            # fall back: close on the first in-SCC successor
            for w in succ.get(cur, ()):
                if w in inside:
                    return path
            return path
        path.append(nxt)
        seen.add(nxt)
        cur = nxt


def _check_cycles(m: Model, by_path: Dict[str, FileInfo]
                  ) -> List[Finding]:
    edges = _lock_edges(m)
    succ: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        succ.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    for v in succ.values():
        v.sort()

    findings: List[Finding] = []
    for comp in _sccs(sorted(nodes), succ):
        if len(comp) < 2:
            continue
        cycle = _cycle_path(comp, succ)
        cyc_edges = [(cycle[i], cycle[(i + 1) % len(cycle)])
                     for i in range(len(cycle))]
        wits = [edges[e] for e in cyc_edges if e in edges]
        if len(cycle) == 2 and all(w[2] == "lexical" for w in wits) \
                and len({w[0] for w in wits}) == 1:
            continue  # v1 lock-order owns same-file lexical ABBA
        wits_sorted = sorted(wits, key=lambda w: (w[0], w[1]))
        path, line = wits_sorted[0][0], wits_sorted[0][1]
        chain = "; ".join(
            f"{w[3]} ({w[0]}:{w[1]})" for w in wits)
        ring = " -> ".join(_short_lock(x) for x in cycle + [cycle[0]])
        info = by_path.get(path)
        findings.append(Finding(
            rule=RULE_CYCLE, file=path, line=line, col=0,
            context="<module>",
            message=f"lock-order cycle {ring}: {chain}",
            line_text=info.line_text(line) if info else ""))
    return findings


# ---------------------------------------------------------------------------
# v1 exoneration: interprocedural with-lock discipline
# ---------------------------------------------------------------------------

def _exonerated_ids(m: Model) -> Set[Tuple[str, str, str]]:
    """(file, context, field) triples whose v1 lock-unguarded-write
    findings are discharged: the function holds the field's declared
    lock on entry from EVERY resolved caller (and has at least one —
    a caller-less function proves nothing)."""
    out: Set[Tuple[str, str, str]] = set()
    for key in sorted(m.funcs):
        if not m.rev.get(key) or key in m.root_targets:
            continue
        held = m.held_entry.get(key)
        if not held:
            continue
        f = m.funcs[key]
        path = m.path_of[key]
        fc = m.conc[path]
        fields: Set[str] = set()
        for w in f.writes:
            lock = _fc_guard(fc, w["owner"], w["field"])
            if lock is None:
                continue
            q = m.qualify_lock(lock, path, f.cls)
            bare = f"{path}::{lock}"
            if q in held or bare in held:
                fields.add(w["field"])
        for fieldname in fields:
            out.add((path, f.context, fieldname))
    return out


def exonerates(finding: Finding,
               exonerated: Set[Tuple[str, str, str]]) -> bool:
    """Should this v1 lock-unguarded-write finding be discharged by the
    interprocedural held-on-entry proof?"""
    if finding.rule != "lock-unguarded-write":
        return False
    mobj = _V1_UNGUARDED_RE.search(finding.message)
    if mobj is None:
        return False
    return (finding.file, finding.context, mobj.group(1)) in exonerated


# ---------------------------------------------------------------------------
# entry point (mirrors interproc.check)
# ---------------------------------------------------------------------------

def check(infos: Sequence[FileInfo],
          conc: Optional[Dict[str, FileConc]] = None,
          aux_infos: Sequence[FileInfo] = ()
          ) -> Tuple[List[Finding], Set[Tuple[str, str, str]]]:
    """Run the three concurrency rules over parsed files plus any
    cached summaries; returns (findings, exonerated-v1-identities).

    ``conc`` maps repo-relative path -> FileConc for files whose
    summaries were restored from the --changed cache; freshly parsed
    ``infos`` are summarized here and take precedence.  ``aux_infos``
    carry lines/pragmas for cache-hit files so findings landing there
    render line_text and honor pragmas.
    """
    merged: Dict[str, FileConc] = dict(conc or {})
    for info in infos:
        if info.tree is not None:
            merged[info.path] = threadmodel.summarize_conc(info)
    if not merged:
        return [], set()
    m = threadmodel.build_model(merged)
    by_path: Dict[str, FileInfo] = {i.path: i for i in aux_infos}
    by_path.update({i.path: i for i in infos})
    findings: List[Finding] = []
    findings.extend(_check_shared(m, by_path))
    findings.extend(_check_affine(m, by_path))
    findings.extend(_check_cycles(m, by_path))
    return findings, _exonerated_ids(m)


def build_model_for(infos: Sequence[FileInfo]) -> Model:
    """The thread model alone (the --threads CLI dump)."""
    merged = {i.path: threadmodel.summarize_conc(i)
              for i in infos if i.tree is not None}
    return threadmodel.build_model(merged)
