"""QuorumIntersectionChecker: does every pair of quorums in the network
intersect?  (ref src/herder/QuorumIntersectionChecker.h:16,
QuorumIntersectionCheckerImpl.cpp — QBitSet graph :373, Tarjan SCC, the
MinQuorumEnumerator pruned powerset recursion :124/:391/:407.)

The port's copy of the JAX package's checker (BASELINE config #3), with
its device tier on a torch device.  The reference enumerates minimal
quorums with a recursive branch-and-bound over BitSets, contracting one
candidate set at a time on CPU.  Here the same search tree is walked as an
explicit work-stack whose *frontier is contracted in batches*: every
expansion needs `contract(committed)` and `contract(perimeter)` for each
open subproblem, and those contractions are a greatest fixpoint of matrix
products (ops/quorum.contract_shared), hundreds of subproblems per chunk.
The early exits are the reference's
(QuorumIntersectionCheckerImpl.cpp:124-261):

  X1   |committed| > |SCC|/2 — the complementary branch finds the witness.
  X3   committed contracts to a quorum Q — terminal either way; if Q is
       *minimal* (no one-node-removed subset is a quorum), check whether
       SCC \\ Q contains a disjoint quorum.
  X2   the perimeter's maximal quorum must extend committed, else no
       quorum in this branch can contain committed.

There is no node cap: pruning keeps realistic (org-structured) topologies
tractable exactly as in the reference, and an ``interrupt`` flag aborts
long scans (ref InterruptedException).

Tier policy, the JAX package's: the native C++ enumerator
(native/quorum_enum.cpp, the port's copy) answers wherever its shape
limits allow (2-level qsets, at most 1024 nodes, no weak orgs); the
numpy enumerator is the host fallback; the device tier contracts the
frontier on a torch device (``cuda`` unless ``device=`` names another)
only past the native tier's 1024-node ceiling, or when the native tier is
switched off.  Its measured rates are in PERF.md.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..ops import quorum as Q
from ..scp import local_node as LN
from ..utils.device import cpu_threads, default_device

# device chunk: the device tier contracts at most this many rows at once
BATCH = 256

# the native enumerator's SCC-width ceiling (native/quorum_enum.cpp
# declines wider problems with rc=-3); past it the batched device
# contractor is the documented last resort
NATIVE_MAX_NODES = 1024


class InterruptedError_(Exception):
    """Scan aborted via the interrupt flag
    (ref QuorumIntersectionChecker::InterruptedException)."""


class _BudgetExhausted(Exception):
    """Internal: the max_calls budget ran out (reported as an aborted
    result, not an exception — unlike an explicit interrupt).  Args: the
    calls made, and the tier that was scanning."""


class InterruptFlag:
    """Cross-tier interrupt flag: settable from any thread, visible to the
    Python enumerator (``is_set``) and polled from the native one via a
    shared int32 (ref std::atomic<bool>& interruptFlag in the checker)."""

    def __init__(self):
        import ctypes

        self._buf = ctypes.c_int32(0)

    def set(self) -> None:
        self._buf.value = 1

    def is_set(self) -> bool:
        return bool(self._buf.value)


class QuorumIntersectionResult:
    def __init__(self, ok: Optional[bool],
                 split: Optional[Tuple[Set[bytes], Set[bytes]]] = None,
                 scanned: int = 0, scc_size: int = 0,
                 aborted: bool = False, tier: Optional[str] = None):
        self.ok = ok            # None when the scan was aborted (unknown)
        self.split = split
        self.scanned = scanned   # enumerator calls (subproblems examined)
        self.scc_size = scc_size
        self.aborted = aborted
        # which evaluation tier answered (or was scanning when the budget
        # ran out): "native" / "numpy" / "device" /
        # "deep-host", prefixed "org:" when the symmetric-org reduction
        # collapsed the scan first (routing policy: native first
        # everywhere its shape limits allow, device only as the >1024-node
        # last resort)
        self.tier = tier


def tarjan_scc(nodes: List[bytes],
               edges: Dict[bytes, Set[bytes]]) -> List[List[bytes]]:
    """Tarjan's strongly-connected components, iterative
    (ref src/util/TarjanSCCCalculator.h)."""
    index: Dict[bytes, int] = {}
    lowlink: Dict[bytes, int] = {}
    on_stack: Set[bytes] = set()
    stack: List[bytes] = []
    sccs: List[List[bytes]] = []
    counter = [0]

    for start in nodes:
        if start in index:
            continue
        work = [(start, iter(sorted(edges.get(start, ()))))]
        index[start] = lowlink[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = lowlink[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[v] = min(lowlink[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


class _Contractor:
    """Batched contract-to-maximal-quorum with a result cache
    (ref contractToMaximalQuorum :407 + the isAQuorum cache :391).

    Three evaluation tiers, bit-identical results:
      - device: ops/quorum.contract_shared on BATCH-row chunks, on a torch
                device (``cuda`` unless ``device`` names another; resolved
                only for this tier, raising where there is no GPU)
      - numpy:  the same masked-matmul fixpoint vectorised on host
      - deep:   per-row recursive host walk for >2-level quorum sets
    """

    def __init__(self, main_scc: List[bytes], qmap: Dict[bytes, object],
                 use_device: bool, device=None):
        self.scc = main_scc
        self.n = len(main_scc)
        self.qmap = qmap
        self._cache: Dict[bytes, np.ndarray] = {}
        universe = set(main_scc)
        plains = []
        self.deep = False
        for node in main_scc:
            p = LN.qset_to_plain(qmap[node])
            if p is None:
                self.deep = True  # >2-level qsets: exact host walk per row
                break
            thr, vals, inners = p
            # restrict memberships to the SCC (outside nodes never vote)
            plains.append((thr, [v for v in vals if v in universe],
                           [(t, [v for v in vs if v in universe])
                            for t, vs in inners]))
        self.plains = None if self.deep else plains
        if not self.deep:
            k = max((len(p[2]) for p in plains), default=0) or 1
            idx = {v: i for i, v in enumerate(main_scc)}
            self.top_mem = np.zeros((self.n, self.n), np.bool_)
            self.top_thr = np.zeros((self.n,), np.int32)
            self.inner_mem = np.zeros((self.n, k, self.n), np.bool_)
            self.inner_thr = np.zeros((self.n, k), np.int32)
            for i, (thr, vals, inners) in enumerate(plains):
                self.top_thr[i] = thr
                for v in vals:
                    self.top_mem[i, idx[v]] = True
                for j, (ithr, ivals) in enumerate(inners):
                    self.inner_thr[i, j] = ithr
                    for v in ivals:
                        self.inner_mem[i, j, idx[v]] = True
        self.use_device = use_device and not self.deep
        if self.use_device:
            # each distinct (threshold, members) element counted once: the
            # org inner sets repeat across nodes
            self.device = default_device(device)
            self._shared = Q.shared_sets(plains, main_scc, self.device)

    @property
    def tier(self) -> str:
        return "device" if self.use_device else \
            ("deep-host" if self.deep else "numpy")

    def contract(self, masks: np.ndarray) -> np.ndarray:
        """masks (B, N) bool -> maximal quorum inside each (B, N) bool."""
        masks = np.asarray(masks, np.bool_)
        out = np.zeros_like(masks)
        miss = []
        for i, row in enumerate(masks):
            hit = self._cache.get(row.tobytes())
            if hit is None:
                miss.append(i)
            else:
                out[i] = hit
        if miss:
            got = self._eval(masks[miss])
            cache_open = len(self._cache) < (1 << 20)  # bounded like the
            for j, i in enumerate(miss):               # native tier's cap
                if cache_open:
                    self._cache[masks[i].tobytes()] = got[j]
                out[i] = got[j]
        return out

    def contract_one(self, mask: np.ndarray) -> np.ndarray:
        return self.contract(mask[None, :])[0]

    def _eval(self, m: np.ndarray) -> np.ndarray:
        if self.deep:
            idx = {v: i for i, v in enumerate(self.scc)}
            rows = []
            for row in m:
                s = {self.scc[j] for j in np.flatnonzero(row)}
                q = _contract_host(s, self.qmap)
                o = np.zeros(self.n, np.bool_)
                for v in q:
                    o[idx[v]] = True
                rows.append(o)
            return np.stack(rows) if rows else m
        if self.use_device:
            # each chunk stops at its fixpoint: the rows of the JAX
            # package's N fixed trips, since a trip only drops nodes
            with cpu_threads(self.device):
                rows = torch.from_numpy(m).to(self.device)
                chunks = [Q.contract_shared(self._shared,
                                            rows[base:base + BATCH])
                          for base in range(0, m.shape[0], BATCH)]
                return torch.cat(chunks).cpu().numpy()
        # numpy fixpoint — mirrors ops/quorum.contract_batch bit-for-bit
        while True:
            s = m.astype(np.int32)
            top = s @ self.top_mem.T.astype(np.int32)          # (B, N)
            inner_ct = np.einsum("ikn,bn->bik",
                                 self.inner_mem.astype(np.int32), s)
            inner_ok = (inner_ct >= self.inner_thr[None]) & \
                (self.inner_thr[None] > 0)
            hits = top + inner_ok.sum(-1, dtype=np.int32)
            nxt = m & (hits >= self.top_thr[None])
            if (nxt == m).all():
                return nxt
            m = nxt


class _MinQuorumEnumerator:
    """Work-stack form of the reference's recursive MinQuorumEnumerator
    (ref QuorumIntersectionCheckerImpl.cpp:124): subproblems are
    (committed, remaining) pairs; each expansion batches its contractions
    through the _Contractor."""

    def __init__(self, contractor: _Contractor, interrupt=None,
                 max_calls: int = 0, deadline: Optional[float] = None):
        self.c = contractor
        self.n = contractor.n
        self.interrupt = interrupt
        self.max_calls = max_calls
        self.deadline = deadline  # time.monotonic() wall-clock cutoff
        self.calls = 0
        # successors(i) = every node reachable through i's qset tree,
        # restricted to the SCC (ref QBitSet::mAllSuccessors) — drives the
        # in-degree split heuristic (ref pickSplitNode, Lachowski's
        # next-node function, deterministic variant)
        universe = set(contractor.scc)
        idx = {v: i for i, v in enumerate(contractor.scc)}
        self.succ = np.zeros((self.n, self.n), np.bool_)
        for i, node in enumerate(contractor.scc):
            for v in LN.qset_nodes(contractor.qmap[node]) & universe:
                self.succ[i, idx[v]] = True

    def _pick_split(self, remaining: np.ndarray) -> int:
        deg = self.succ[remaining].sum(0) * remaining
        if deg.max(initial=0) == 0:
            return int(np.flatnonzero(remaining).max())
        top = np.flatnonzero(deg == deg.max())
        return int(top.max())

    def _is_minimal(self, q: np.ndarray) -> bool:
        """No one-node-removed subset of q contains a quorum
        (ref isMinimalQuorum :449)."""
        members = np.flatnonzero(q)
        probes = np.repeat(q[None, :], len(members), 0)
        probes[np.arange(len(members)), members] = False
        sub = self.c.contract(probes)
        return not sub.any(axis=1).any()

    def run(self, scc_mask: np.ndarray,
            shareable: Optional[np.ndarray] = None,
            use_x1: bool = True
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Return (min-quorum, disjoint-quorum) masks, or None if every
        min-quorum's complement is quorum-free (⇒ intersection holds).

        ``shareable``: nodes both quorums may contain (used by the
        symmetric-org reduction, where a "weak" org can serve two disjoint
        node-level quorums); the complement scan then only excludes the
        min-quorum's non-shareable part.  X1 (the committed > |SCC|/2
        early exit) relies on pure complementarity and must be disabled
        whenever shareable nodes exist.
        """
        if shareable is None:
            shareable = np.zeros(self.n, np.bool_)
        elif shareable.any():
            use_x1 = False
        max_commit = int(scc_mask.sum()) // 2 if use_x1 else self.n
        stack = [(np.zeros(self.n, np.bool_), scc_mask.copy())]
        while stack:
            if self.interrupt is not None and self.interrupt.is_set():
                raise InterruptedError_()
            if self.max_calls and self.calls >= self.max_calls:
                raise _BudgetExhausted(self.calls, self.c.tier)
            if self.deadline is not None:
                import time as _time

                # scan-budget cutoff only: an expired deadline aborts
                # with an explicit "exhausted" verdict, never silently
                # changes an intersection answer
                # detlint: allow(det-wallclock)
                if _time.monotonic() > self.deadline:
                    raise _BudgetExhausted(self.calls, self.c.tier)
            batch = stack[-BATCH:]
            del stack[-len(batch):]
            self.calls += len(batch)
            # X1 needs no contraction
            live = [(c, r) for (c, r) in batch if c.sum() <= max_commit]
            if not live:
                continue
            committed = np.stack([c for c, _ in live])
            perimeter = np.stack([c | r for c, r in live])
            cq = self.c.contract(np.concatenate([committed, perimeter]))
            committed_q, perimeter_q = cq[:len(live)], cq[len(live):]
            for (c, r), q, eq in zip(live, committed_q, perimeter_q):
                if q.any():
                    # X3: terminal; minimal ⇒ examine the complement
                    if self._is_minimal(q):
                        disj = self.c.contract_one(
                            scc_mask & ~(q & ~shareable))
                        if disj.any():
                            return q, disj
                    continue
                if not eq.any() or (c & ~eq).any():
                    continue  # X2.1 / X2.2
                if not r.any():
                    continue  # remainder exhausted
                split = self._pick_split(r)
                r2 = r.copy()
                r2[split] = False
                c2 = c.copy()
                c2[split] = True
                stack.append((c, r2))
                stack.append((c2, r2))
        return None


def _pack_masks(mat: np.ndarray) -> np.ndarray:
    """(R, n) bool -> (R, W) uint64, bit i of a row at word i>>6, bit i&63
    (the native enumerator's word layout)."""
    r, n = mat.shape
    w = (n + 63) // 64
    padded = np.zeros((r, w * 64), np.bool_)
    padded[:, :n] = mat
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(r, w, 64).astype(np.uint64) * weights).sum(
        -1, dtype=np.uint64)


def _unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    bits = (words[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(-1)[:n].astype(np.bool_)


def _check_native(contractor: _Contractor, interrupt, max_calls: int = 0):
    """Run the branch-and-bound in the native tier
    (native/quorum_enum.cpp).  Returns (split_or_None, calls) or None when
    the 2-level shape or the width is outside the native tier's limits.
    Raises when the library does not build."""
    if contractor.deep:
        return None
    from .. import native as native_mod

    lib = native_mod.get_lib()
    import ctypes

    n = contractor.n
    w = (n + 63) // 64
    top_thr = np.ascontiguousarray(contractor.top_thr, np.int32)
    top_mem = np.ascontiguousarray(_pack_masks(contractor.top_mem))
    idx = {v: i for i, v in enumerate(contractor.scc)}
    inner_off = np.zeros(n + 1, np.int32)
    inner_thrs: List[int] = []
    inner_rows: List[np.ndarray] = []
    for i, (_, _, inners) in enumerate(contractor.plains):
        for ithr, ivals in inners:
            row = np.zeros(n, np.bool_)
            for v in ivals:
                row[idx[v]] = True
            inner_thrs.append(ithr)
            inner_rows.append(row)
        inner_off[i + 1] = len(inner_thrs)
    inner_thr = np.ascontiguousarray(inner_thrs or [0], np.int32)
    inner_mem = np.ascontiguousarray(_pack_masks(
        np.stack(inner_rows) if inner_rows else np.zeros((1, n), np.bool_)))

    out_q1 = np.zeros(w, np.uint64)
    out_q2 = np.zeros(w, np.uint64)
    out_calls = ctypes.c_int64(0)
    if interrupt is not None and interrupt.is_set():
        raise InterruptedError_()
    # the native scan polls a shared int32: an InterruptFlag carries one
    # natively; any other Event-like interrupt gets a polling bridge
    # thread so set() still aborts a running scan
    bridge_done = None
    if isinstance(interrupt, InterruptFlag):
        flag = interrupt
    else:
        flag = InterruptFlag()
        if interrupt is not None:
            import threading

            bridge_done = threading.Event()

            def _bridge():
                while not bridge_done.wait(0.05):
                    if interrupt.is_set():
                        flag.set()
                        return

            threading.Thread(target=_bridge, daemon=True).start()
    int_ptr = ctypes.byref(flag._buf)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    try:
        rc = lib.quorum_enum_check(
            n,
            top_thr.ctypes.data_as(p32), top_mem.ctypes.data_as(pu64),
            inner_off.ctypes.data_as(p32), inner_thr.ctypes.data_as(p32),
            inner_mem.ctypes.data_as(pu64),
            ctypes.cast(int_ptr, p32),
            max_calls,
            out_q1.ctypes.data_as(pu64), out_q2.ctypes.data_as(pu64),
            ctypes.byref(out_calls))
    finally:
        if bridge_done is not None:
            bridge_done.set()
    if rc == -3:
        return None  # SCC wider than the native tier's 1024-node ceiling
    if rc == -1:
        raise InterruptedError_()
    if rc == -2:
        return ("aborted", out_calls.value)
    if rc == 1:
        return ((_unpack_mask(out_q1, n), _unpack_mask(out_q2, n)),
                out_calls.value)
    return (None, out_calls.value)


def _try_org_reduction(main_scc: List[bytes], qmap: Dict[bytes, object]):
    """Symmetric-organisation reduction: when every node's quorum set is a
    pure org form — a threshold over disjoint inner sets ("orgs"), with all
    members of an org sharing one identical qset and each org carrying one
    consistent inner threshold — the node-level intersection question
    reduces to an org-level one:

      a node-minimal quorum takes either 0 or exactly t_i members of org i
      (any extra member could be dropped), so disjoint node-level quorums
      exist  iff  two org-level quorums overlap only in "weak" orgs
      (2·t_i <= |org i|: the org can serve both sides with disjoint
      members).

    This is the standard symmetric-cluster collapse for FBAS analysis; the
    production Stellar topology (3-validator orgs) is exactly this shape,
    and it turns a 36-node scan into a 12-org one.  Returns None when the
    network is not in pure org form (the general enumerator runs instead),
    else ``(org_reps, org_qmap, weak_reps, groups)`` where ``groups`` maps
    an org rep to its ordered member list and threshold.
    """
    universe = set(main_scc)
    plains = {}
    for node in main_scc:
        p = LN.qset_to_plain(qmap[node])
        if p is None:
            return None
        thr, vals, inners = p
        if vals:
            return None  # top-level individual validators: not org form
        restricted = []
        seen_inner = set()
        for t, members in inners:
            fs = frozenset(members) & universe
            if len(fs) < t:
                # not satisfiable inside the scan (covers fs empty and
                # orgs whose threshold exceeds their in-SCC membership):
                # dropping it is exactly what contraction would do
                continue
            if fs in seen_inner:
                return None  # duplicate inner set: counts would double
            seen_inner.add(fs)
            restricted.append((t, fs))
        if not restricted:
            return None
        plains[node] = (thr, restricted)

    # orgs = the distinct inner sets; must partition the universe with one
    # consistent threshold each
    org_thr: Dict[frozenset, int] = {}
    for _, (thr, inners) in sorted(plains.items()):
        for t, fs in inners:
            if org_thr.setdefault(fs, t) != t:
                return None
    seen: Set[bytes] = set()
    for fs in org_thr:
        if fs & seen:
            return None  # overlapping orgs
        seen |= fs
    if seen != universe:
        return None
    # every member of an org shares one identical qset
    group_of: Dict[bytes, frozenset] = {}
    for fs in org_thr:
        canon = None
        for v in fs:
            mine = (plains[v][0],
                    frozenset((t, f) for t, f in plains[v][1]))
            if canon is None:
                canon = mine
            elif mine != canon:
                return None
            group_of[v] = fs
    org_reps = {fs: min(fs) for fs in org_thr}
    org_qmap = {}
    for fs in org_thr:
        thr, inners = plains[min(fs)]
        org_qmap[org_reps[fs]] = LN.make_qset(
            thr, sorted(org_reps[f] for _, f in inners))
    weak_reps = {org_reps[fs] for fs, t in org_thr.items()
                 if 2 * t <= len(fs)}
    groups = {org_reps[fs]: (sorted(fs), org_thr[fs]) for fs in org_thr}
    return org_reps, org_qmap, weak_reps, groups


def _native_call_cap(max_calls: int, deadline) -> int:
    """The native tier has no clock: convert the wall budget LEFT to a
    call cap at its ~1M calls/s throughput (the cap shrinks with elapsed
    time)."""
    import time as _time

    if deadline is None:
        return max_calls
    # detlint: allow(det-wallclock) — wall budget, not consensus data
    remaining = max(0.0, deadline - _time.monotonic())
    time_cap = max(1, int(remaining * 1_000_000))
    return min(max_calls or time_cap, time_cap)


def _solve_org_level(org_qmap, weak_reps, groups, interrupt, use_device,
                     max_calls=0, deadline=None, use_native=True,
                     device=None):
    """Run the enumerator on the collapsed org-level network and map a
    found org split back to disjoint node-level quorums.  Returns
    (split_or_None, calls, tier) — or raises _BudgetExhausted.

    Tier routing: the native C++ enumerator answers first whenever its
    semantics apply — that is, whenever there are no weak orgs (a weak org
    may serve two disjoint node-level quorums, which needs the
    shareable-complement scan only the Python enumerator implements).  The
    device-batch contractor is NOT tried before native."""
    reps = sorted(org_qmap)
    n = len(reps)
    no_weak = not weak_reps
    contractor = _Contractor(
        reps, org_qmap,
        use_device and (not use_native or n > NATIVE_MAX_NODES), device)
    found = None
    calls = 0
    tier = None
    if use_native and no_weak:
        native_res = _check_native(contractor, interrupt,
                                   _native_call_cap(max_calls, deadline))
        if native_res is not None:
            found, calls = native_res
            if found == "aborted":
                raise _BudgetExhausted(calls, "native")
            tier = "native"
    if tier is None:
        enum = _MinQuorumEnumerator(contractor, interrupt, max_calls,
                                    deadline)
        shareable = np.array([r in weak_reps for r in reps], np.bool_)
        tier = contractor.tier
        found = enum.run(np.ones(n, np.bool_), shareable=shareable)
        calls = enum.calls
    if found is None:
        return None, calls, tier
    a_mask, b_mask = found
    a = {reps[j] for j in np.flatnonzero(a_mask)}
    b = {reps[j] for j in np.flatnonzero(b_mask)}
    s1: Set[bytes] = set()
    s2: Set[bytes] = set()
    for rep in a:
        members, t = groups[rep]
        s1.update(members[:t])
    for rep in b:
        members, t = groups[rep]
        # shared (necessarily weak) orgs serve both sides with disjoint
        # member slices: 2t <= |org|
        s2.update(members[-t:] if rep in a else members[:t])
    return (s1, s2), calls, tier


def check_quorum_intersection(qmap: Dict[bytes, object],
                              use_device: bool = True,
                              interrupt=None,
                              use_native: bool = True,
                              max_calls: int = 0,
                              max_seconds: Optional[float] = None,
                              device=None) -> QuorumIntersectionResult:
    """qmap: node id -> XDR SCPQuorumSet.  Nodes with unknown (None) qsets
    are excluded, like the reference's missing-qset handling.

    ``interrupt``: optional Event-like object (or InterruptFlag) checked
    during the scan; setting it raises InterruptedError_.  ``max_calls``
    (0 = unlimited) and ``max_seconds`` (None = unlimited; enforced as a
    wall-clock deadline on the Python tiers and converted to a call cap
    for the native one) bound the branch-and-bound: the problem is
    NP-hard and qsets arrive from the network, so synchronous callers
    (admin HTTP, self-check) must cap the scan — an exhausted budget
    returns ``ok=None, aborted=True`` (verdict unknown), never a false
    verdict.

    ``device``: the torch device of the device tier (``cuda`` unless it
    names another), resolved only when that tier is chosen; without a GPU
    and without ``device`` the device tier raises.

    Insane quorum sets (threshold < 1 anywhere, etc.) are excluded up
    front like unknown ones: the reference never admits them to the
    tracker (isQuorumSetSane at receipt), and the evaluation tiers'
    threshold-0 semantics would otherwise diverge."""
    from ..scp.quorum_sanity import is_quorum_set_sane

    qmap = {n: q for n, q in qmap.items()
            if q is not None and is_quorum_set_sane(q)}
    nodes = sorted(qmap)
    if not nodes:
        return QuorumIntersectionResult(True)

    # dependency graph: n -> nodes its qset references (ref buildGraph)
    edges = {n: (LN.qset_nodes(q) & set(nodes)) for n, q in qmap.items()}
    sccs = tarjan_scc(nodes, edges)
    # quorums in two different SCCs are disjoint by construction — the
    # reference fails fast in that case and otherwise restricts the scan
    # to the single quorum-bearing SCC (ref
    # networkEnjoysQuorumIntersection checking exactly one SCC has quorums)
    quorum_sccs = []
    for comp in sorted(sccs, key=len, reverse=True):
        q = _contract_host(set(comp), qmap)
        if q:
            quorum_sccs.append((sorted(comp), q))
    if not quorum_sccs:
        return QuorumIntersectionResult(True, scc_size=0)
    if len(quorum_sccs) > 1:
        return QuorumIntersectionResult(
            False, (quorum_sccs[0][1], quorum_sccs[1][1]),
            0, len(quorum_sccs[0][0]))
    main_scc = quorum_sccs[0][0]
    n = len(main_scc)

    import time as _time

    # detlint: allow(det-wallclock) — scan timeout budget, not consensus
    deadline = (_time.monotonic() + max_seconds
                if max_seconds is not None else None)
    try:
        reduction = _try_org_reduction(main_scc, qmap)
        if reduction is not None:
            _, org_qmap, weak_reps, groups = reduction
            split, calls, tier = _solve_org_level(
                org_qmap, weak_reps, groups, interrupt, use_device,
                max_calls, deadline, use_native=use_native, device=device)
            tier = "org:" + tier
            _log_tier(tier, n, calls)
            if split is not None:
                return QuorumIntersectionResult(False, split, calls, n,
                                                tier=tier)
            return QuorumIntersectionResult(True, None, calls, n,
                                            tier=tier)

        # device-batch contraction is the documented last resort: only
        # past the native tier's width ceiling (or when native is
        # explicitly disabled for benchmarking)
        contractor = _Contractor(
            main_scc, qmap,
            use_device and (not use_native or n > NATIVE_MAX_NODES), device)
        if use_native:
            native_res = _check_native(
                contractor, interrupt, _native_call_cap(max_calls,
                                                        deadline))
            if native_res is not None:
                found, calls = native_res
                if found == "aborted":
                    return QuorumIntersectionResult(None, None, calls, n,
                                                    aborted=True,
                                                    tier="native")
                _log_tier("native", n, calls)
                if found is not None:
                    q1, q2 = found
                    return QuorumIntersectionResult(
                        False,
                        ({main_scc[j] for j in np.flatnonzero(q1)},
                         {main_scc[j] for j in np.flatnonzero(q2)}),
                        calls, n, tier="native")
                return QuorumIntersectionResult(True, None, calls, n,
                                                tier="native")
        tier = contractor.tier
        enum = _MinQuorumEnumerator(contractor, interrupt, max_calls,
                                    deadline)
        found = enum.run(np.ones(n, np.bool_))
    except _BudgetExhausted as exc:
        # unlike the JAX package, which drops it for the Python tiers, an
        # aborted result names the tier that was scanning
        scanned, tier = exc.args
        if reduction is not None:
            tier = "org:" + tier
        return QuorumIntersectionResult(None, None, scanned, n,
                                        aborted=True, tier=tier)
    _log_tier(tier, n, enum.calls)
    if found is not None:
        q1, q2 = found
        return QuorumIntersectionResult(
            False,
            ({main_scc[j] for j in np.flatnonzero(q1)},
             {main_scc[j] for j in np.flatnonzero(q2)}),
            enum.calls, n, tier=tier)
    return QuorumIntersectionResult(True, None, enum.calls, n, tier=tier)


def _log_tier(tier: str, scc_size: int, calls: int) -> None:
    """Which tier answered a scan, for operators: one
    info line per completed scan, Herder partition."""
    from ..utils.logging import get_logger

    get_logger("Herder").info(
        "quorum intersection answered by %s tier (scc=%d, calls=%d)",
        tier, scc_size, calls)


def _contract_host(members: Set[bytes],
                   qmap: Dict[bytes, object]) -> Set[bytes]:
    """Host contraction to the maximal quorum inside ``members``
    (ref contractToMaximalQuorum) — exact at any qset nesting depth."""
    cur = set(members)
    while True:
        nxt = {n for n in cur
               if n in qmap and LN.is_quorum_slice(qmap[n], cur)}
        if nxt == cur:
            return cur
        cur = nxt
