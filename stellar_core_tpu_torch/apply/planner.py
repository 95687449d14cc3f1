"""Conflict-cluster scheduler: footprints -> deterministic clusters.

Two transactions conflict when one's declared WRITE set intersects the
other's declared read-or-write set, when they touch the same order-book
pair, or when both may allocate from the offer-id pool (a global
header counter whose values are consensus-visible).  Conflicts are
closed transitively with union-find over the canonical apply order;
each resulting cluster preserves intra-cluster canonical order and the
clusters themselves are emitted in ascending first-tx order, so the
whole plan is a pure function of (tx set, ledger state) — no
iteration-order dependence, no randomness.

``plan_parallel_apply`` returns ``None`` when the set cannot be
parallelized (an imprecise footprint, or fewer than two clusters):
the caller then runs the ordinary sequential loop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .footprint import PlanContext, TxFootprint, footprint_for

#: conflict token for offer-id-pool allocation (header.idPool)
IDPOOL_TOKEN = ("header", "idpool")


class Cluster:
    """One parallel unit: canonical-order tx indices + merged footprint."""

    __slots__ = ("cluster_id", "indices", "keys", "writes", "pairs",
                 "writes_header", "kernel_ok", "shapes")

    def __init__(self, cluster_id: int):
        self.cluster_id = cluster_id
        self.indices: List[int] = []
        self.keys: Set[bytes] = set()    # reads | writes
        self.writes: Set[bytes] = set()
        self.pairs: Set[Tuple[bytes, bytes]] = set()
        self.writes_header = False
        # every member tx is kernel-shaped: the executor may hand the
        # whole cluster to the native apply kernel (state-level checks
        # happen inside the kernel, which declines back to Python);
        # ``shapes`` holds the per-tx kernel descriptors, parallel to
        # ``indices`` (entries are None for non-eligible txs)
        self.kernel_ok = True
        self.shapes: List[Optional[tuple]] = []


class ApplyPlan:
    __slots__ = ("clusters", "footprints", "context", "stats")

    def __init__(self, clusters: List[Cluster],
                 footprints: List[TxFootprint],
                 context: PlanContext, stats: dict):
        self.clusters = clusters
        self.footprints = footprints
        self.context = context
        self.stats = stats


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]
            i = p[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # smaller index wins: keeps representatives canonical
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def plan_parallel_apply(apply_order, ltx, allow_single_native: bool = False
                        ) -> Tuple[Optional[ApplyPlan], dict]:
    """Footprint every tx, build the conflict graph, emit clusters.

    ``ltx`` is the open close LedgerTxn (post-fee state) — used for
    plan-time materialization only; never retained by worker threads.
    Returns ``(plan, stats)``; ``plan`` is None (with no side effects)
    when the set has an imprecise footprint or collapses into a single
    cluster — ``stats["unplanned"]`` then says why.

    ``allow_single_native``: emit a one-cluster plan anyway when that
    cluster is kernel-eligible — the executor applies it INLINE through
    the native kernel (the adversarial-ring case turns from planner
    refusal into a native fast path; a kernel decline still lands on
    the ordinary sequential loop).
    """
    n = len(apply_order)
    ctx = PlanContext(ltx)
    footprints: List[TxFootprint] = []
    for i, frame in enumerate(apply_order):
        fp = footprint_for(i, frame, ctx)
        if not fp.precise:
            return None, {"txs": n, "clusters": 0,
                          "unplanned": fp.reason, "tx_index": i}
        footprints.append(fp)

    uf = _UnionFind(n)
    # token -> representative of the merged group holding its write;
    # readers seen before any writer wait in readers_pending
    writer_of: Dict[object, int] = {}
    readers_pending: Dict[object, List[int]] = {}
    conflict_edges = 0

    def declare_write(i: int, token) -> None:
        nonlocal conflict_edges
        w = writer_of.get(token)
        if w is not None and uf.find(w) != uf.find(i):
            uf.union(i, w)
            conflict_edges += 1
        for r in readers_pending.pop(token, ()):
            if uf.find(r) != uf.find(i):
                uf.union(i, r)
                conflict_edges += 1
        writer_of[token] = uf.find(i)

    def declare_read(i: int, token) -> None:
        nonlocal conflict_edges
        w = writer_of.get(token)
        if w is not None:
            if uf.find(w) != uf.find(i):
                uf.union(i, w)
                conflict_edges += 1
        else:
            readers_pending.setdefault(token, []).append(i)

    pair_rep: Dict[Tuple[bytes, bytes], int] = {}
    for i, fp in enumerate(footprints):
        for kb in sorted(fp.writes):
            declare_write(i, kb)
        for pair in sorted(fp.book_pairs):
            declare_write(i, ("book", pair))
            pair_rep.setdefault(pair, i)
        if fp.allocates_offer_ids:
            declare_write(i, IDPOOL_TOKEN)
        for kb in sorted(fp.reads - fp.writes):
            declare_read(i, kb)
    # each materialized book joins the conflict graph ONCE, through the
    # first tx touching its pair: every resting offer / seller /
    # trustline / sponsor key the book reaches merges any tx that
    # declared it into the pair's group (a payment crediting a resting
    # seller must not run concurrently with crossings consuming that
    # seller's offer)
    for pair in sorted(pair_rep):
        rep = pair_rep[pair]
        mat = ctx.books[pair]
        for kb in sorted(mat.keys):
            declare_write(rep, kb)
        for kb in sorted(mat.read_keys):
            declare_read(rep, kb)

    by_root: Dict[int, Cluster] = {}
    clusters: List[Cluster] = []
    for i in range(n):
        root = uf.find(i)
        cluster = by_root.get(root)
        if cluster is None:
            cluster = Cluster(len(clusters))
            by_root[root] = cluster
            clusters.append(cluster)
        cluster.indices.append(i)
        fp = footprints[i]
        cluster.keys |= fp.all_keys()
        cluster.writes |= fp.writes
        cluster.pairs |= fp.book_pairs
        cluster.writes_header |= fp.allocates_offer_ids
        cluster.kernel_ok &= fp.kernel_shape is not None
        cluster.shapes.append(fp.kernel_shape)
    for cluster in clusters:
        for pair in cluster.pairs:
            mat = ctx.books[pair]
            cluster.keys |= mat.keys
            cluster.keys |= mat.read_keys
            cluster.writes |= mat.keys

    widths = [len(c.indices) for c in clusters]
    stats = {
        "txs": n,
        "clusters": len(clusters),
        "max_width": max(widths) if widths else 0,
        "singletons": sum(1 for w in widths if w == 1),
        "conflict_edges": conflict_edges,
        "conflict_rate": round(1.0 - len(clusters) / n, 4) if n else 0.0,
        "book_pairs": len(ctx.books),
        "kernel_clusters": sum(1 for c in clusters if c.kernel_ok),
    }
    if len(clusters) < 2:
        if allow_single_native and clusters and clusters[0].kernel_ok:
            stats["single_native"] = True
            return ApplyPlan(clusters, footprints, ctx, stats), stats
        stats["unplanned"] = "single cluster"
        return None, stats
    return ApplyPlan(clusters, footprints, ctx, stats), stats
