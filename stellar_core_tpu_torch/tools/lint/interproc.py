"""Interprocedural determinism taint (detlint v2 layer 1).

The v1 rules are strictly intra-function: ``det-wallclock`` flags a
time read *in a consensus module*, ``det-unsorted-iter`` flags unsorted
iteration *in the same function* as a hash/serialize/tally sink.  The
structural escape both share: a nondeterministic value produced in one
helper — possibly outside the consensus directories entirely — and fed
through a call into a consensus sink function.  This pass closes it:

1. every function in the package gets a summary (callgraph.py) listing
   its direct nondeterminism sources (wall-clock/RNG/uuid reads,
   os.environ, ``id()``, order-carrying unsorted dict/set iteration,
   float math on ledger values) and resolved call sites;
2. taint propagates callee -> caller up to ``MAX_TAINT_DEPTH`` edges
   (a function is tainted when it contains a source or calls a tainted
   function — the return-value/argument flow approximation);
3. a finding fires at each call site inside a consensus-directory
   function that feeds a hash/serialize/tally sink and calls a tainted
   callee.  The message carries the full source->sink chain so the fix
   is one look:

     close_hash -> _mix -> _stamp (wallclock time.time() at
     stellar_core_tpu/scp/helpers.py:12)

Suppression composes with v1: a pragma at the SOURCE line for the
matching v1 rule (or ``det-interproc-taint``) sanctions every chain
from that source; a pragma at the call site suppresses just that sink.
A source directly inside the sink function is NOT reported here — the
v1 intra-function rules own that case.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import callgraph
from .callgraph import INTERPROC_RULE, MAX_TAINT_DEPTH, Graph
from .engine import (CONSENSUS_DIRS, PACKAGE, FileInfo, Finding,
                     path_under)


def _in_consensus(path: str) -> bool:
    return path_under(path, CONSENSUS_DIRS)


class Taint:
    """Per-function taint verdict with the shortest witness chain."""

    __slots__ = ("depth", "via", "source")

    def __init__(self, depth: int, via: Optional[str],
                 source: Tuple[str, str, int]):
        self.depth = depth       # call edges from the direct source
        self.via = via           # callee key one step toward the source
        self.source = source     # (kind, detail, line) at the origin


def propagate(graph: Graph) -> Dict[str, Taint]:
    """Breadth-first from every source-bearing function along REVERSE
    call edges, bounded by MAX_TAINT_DEPTH; keeps the shallowest chain
    per function (ties broken deterministically by key order)."""
    callers: Dict[str, List[str]] = {}
    for caller, edges in graph.edges.items():
        for callee, _line in edges:
            callers.setdefault(callee, []).append(caller)

    from .callgraph import SANCTIONED_MODULES

    tainted: Dict[str, Taint] = {}
    frontier: List[str] = []
    for key in sorted(graph.funcs):
        f = graph.funcs[key]
        if f.sources:
            src = min(f.sources, key=lambda s: (s[2], s[0]))
            tainted[key] = Taint(0, None, src)
            frontier.append(key)
    # the sink's own call edge is the +1: propagating to depth
    # MAX_TAINT_DEPTH - 1 bounds the full reported chain (sink -> ...
    # -> source) at MAX_TAINT_DEPTH call edges
    depth = 0
    while frontier and depth < MAX_TAINT_DEPTH - 1:
        depth += 1
        nxt: List[str] = []
        for key in frontier:
            for caller in sorted(callers.get(key, ())):
                if caller in tainted:
                    continue
                if graph.path_of[caller] in SANCTIONED_MODULES:
                    # sanctioned modules are neither sources NOR
                    # carriers: a chain laundered through clock/
                    # tracing/config is observability or config
                    # plumbing, not a consensus value flow (documented
                    # blind spot in COVERAGE.md)
                    continue
                tainted[caller] = Taint(depth, key, tainted[key].source)
                nxt.append(caller)
        frontier = nxt
    return tainted


def _chain_text(graph: Graph, start: str,
                tainted: Dict[str, Taint]) -> str:
    names: List[str] = []
    key: Optional[str] = start
    while key is not None:
        f = graph.funcs[key]
        names.append(f.context)
        key = tainted[key].via
    t = tainted[start]
    kind, detail, line = t.source
    origin_path = graph.path_of[_chain_end(graph, start, tainted)]
    return (" -> ".join(names)
            + f" ({kind} {detail} at {origin_path}:{line})")


def _chain_end(graph: Graph, start: str,
               tainted: Dict[str, Taint]) -> str:
    key = start
    while tainted[key].via is not None:
        key = tainted[key].via
    return key


def check(infos: List[FileInfo],
          summaries: Optional[Dict[str, List[callgraph.FuncSummary]]]
          = None,
          aux_infos: "tuple" = ()) -> List[Finding]:
    """Whole-program pass over the given files.  ``summaries`` lets the
    --changed cache substitute precomputed per-file summaries; files in
    ``infos`` are (re)summarized from their ASTs.  ``aux_infos`` carries
    tree-less FileInfo objects for cache-hit files so findings landing
    there still render real line text."""
    merged: Dict[str, List[callgraph.FuncSummary]] = dict(summaries or {})
    by_path = {i.path: i for i in aux_infos}
    by_path.update({i.path: i for i in infos})
    for info in infos:
        merged[info.path] = callgraph.summarize_file(info)
    graph = callgraph.build(merged)
    tainted = propagate(graph)

    findings: List[Finding] = []
    seen = set()
    for key in sorted(graph.funcs):
        path = graph.path_of[key]
        f = graph.funcs[key]
        if not f.sink or not _in_consensus(path):
            continue
        for callee, line in graph.edges[key]:
            t = tainted.get(callee)
            if t is None:
                continue
            kind = t.source[0]
            dedupe = (key, callee, kind)
            if dedupe in seen:
                continue
            seen.add(dedupe)
            chain = f.context + " -> " + _chain_text(graph, callee,
                                                     tainted)
            info = by_path.get(path)
            line_text = info.line_text(line) if info is not None else ""
            findings.append(Finding(
                rule=INTERPROC_RULE, file=path, line=line, col=0,
                context=f.context,
                message=("nondeterministic value reaches a hash/"
                         f"serialize/tally scope: {chain}"),
                line_text=line_text))
    return findings
