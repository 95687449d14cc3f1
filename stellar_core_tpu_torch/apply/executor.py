"""Bit-identical concurrent executor for planned apply clusters.

Execution model
---------------
The close's main thread snapshots every declared footprint key (plus
the materialized order books) out of the open close ``LedgerTxn`` into
one immutable ``ApplySnapshot``, then runs each cluster as a task on
the worker pool.  A cluster applies its transactions — in canonical
order — through an ordinary ``LedgerTxn`` whose parent is a
``ClusterView``: a read-only window onto the snapshot restricted to
the cluster's declared footprint.

The speculation guard IS the ``ClusterView``: any ``get`` outside the
declared key set, any ``best_offer`` on an undeclared pair, and any
scan the plan did not materialize raises ``FootprintEscape``.  The
executor then abandons the whole parallel attempt (no cluster delta
ever reaches the close LedgerTxn) and the caller replays the set
sequentially — the always-correct fallback — while the
``apply.parallel.abort`` counter and the close's ``ledger.apply.*``
spans record the event.

Bit-identity argument (why merged results equal sequential apply):
clusters are closed under declared write/read conflicts, so a tx's
reads either hit pre-apply state (identical to what sequential apply
would serve, because no other cluster may write them) or intra-cluster
writes (applied in canonical order).  Undeclared accesses cannot
silently diverge — they escape.  Header mutation (offer-id
allocation) is confined to the single cluster holding the id-pool
token.  Cluster deltas are disjoint by construction, so merging them
in cluster order reproduces the sequential delta exactly; meta STATE
entries read through the same chain and match byte-for-byte.

The GIL note: transaction apply is host Python, so clusters time-slice
one interpreter — the wall-clock win comes from overlapping the
GIL-releasing native work (xdrpack meta/result/envelope serialization
done eagerly inside each worker) with other clusters' Python, and from
the close path consuming those pre-encoded bytes instead of
re-encoding (tx history rows, result-set hashing).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..ledger.ledger_txn import LedgerTxn, VIRTUAL_PREFIX, _OFFER_PREFIX
from ..xdr import types as T
from .planner import ApplyPlan, plan_parallel_apply


class FootprintEscape(Exception):
    """A cluster touched state outside its declared footprint."""


_MISS = object()


class ApplySnapshot:
    """Immutable pre-apply state shared by every cluster (built on the
    main thread, read-only afterwards — no locking needed)."""

    __slots__ = ("store", "header", "books", "idpool0", "pool_quote")

    def __init__(self, store: Dict[bytes, object], header, books,
                 idpool0: int, pool_quote: bool = True):
        self.store = store
        self.header = header
        # pair token -> {direction (selling, buying): sorted
        #               [(Fraction, offerID, kb)]}
        self.books = books
        self.idpool0 = idpool0
        # NATIVE_POOL_QUOTE kill switch: False restores the pre-r16
        # decline-if-live-pool host screen (native_apply._screen_cluster)
        self.pool_quote = pool_quote


def _is_fresh_offer_key(kb: bytes, idpool0: int) -> bool:
    """Offer keys minted this close carry ids beyond the pre-apply
    idPool — they cannot exist in pre-state nor belong to any other
    cluster (only the id-pool cluster allocates)."""
    if len(kb) != 48 or not kb.startswith(_OFFER_PREFIX):
        return False
    offer_id = int.from_bytes(kb[40:48], "big", signed=True)
    return offer_id > idpool0


class ClusterView:
    """Read-only LedgerTxn parent enforcing one cluster's footprint.

    Implements the parent surface LedgerTxn fall-through uses: ``get``
    / ``header`` plus the root query hooks (``_best_offer``,
    ``_offers_by_seller``, ``_entries_by_key_prefix``)."""

    __slots__ = ("snapshot", "store", "pairs", "abort", "_child")

    def __init__(self, snapshot: ApplySnapshot, cluster, abort):
        self.snapshot = snapshot
        # pre-restricted store: declared-key reads are ONE dict lookup
        # (this get underlies every entry load in the cluster's apply
        # loop — the speculation guard must not tax the hot path)
        self.store = {kb: snapshot.store[kb] for kb in cluster.keys}
        self.pairs = cluster.pairs
        self.abort = abort
        self._child = None  # LedgerTxn child-tracking protocol

    # -- reads --------------------------------------------------------------

    def get(self, kb: bytes):
        v = self.store.get(kb, _MISS)
        if v is not _MISS:
            return v
        if kb.startswith(VIRTUAL_PREFIX):
            return None  # sponsorship bookkeeping never exists pre-tx
        if _is_fresh_offer_key(kb, self.snapshot.idpool0):
            return None  # created this close by THIS cluster
        raise FootprintEscape(f"undeclared key access: {kb.hex()}")

    def header(self):
        return self.snapshot.header

    # -- root query hooks (LedgerTxn.best_offer / offers_by_account /
    #    entries_by_key_prefix end their layer walk here) ------------------

    def _best_offer(self, selling: bytes, buying: bytes,
                    overrides, worse_than=None):
        from .footprint import pair_token

        pair = pair_token(selling, buying)
        if pair not in self.pairs:
            raise FootprintEscape(
                "undeclared order-book scan: "
                f"{selling.hex()[:16]}/{buying.hex()[:16]}")
        candidates = []
        for price, oid, kb in self.snapshot.books[pair][(selling, buying)]:
            if kb in overrides:
                continue
            key = (price, oid)
            if worse_than is not None and key <= worse_than:
                continue
            candidates.append((*key, kb))
            break  # book rows are sorted: first unshadowed row wins…
        # …but an override may still beat it
        for kb, e in sorted(overrides.items()):
            if e is None:
                continue
            o = e.data.value
            if (T.Asset.encode(o.selling) != selling
                    or T.Asset.encode(o.buying) != buying):
                continue
            from fractions import Fraction

            key = (Fraction(o.price.n, o.price.d), o.offerID)
            if worse_than is not None and key <= worse_than:
                continue
            candidates.append((*key, kb))
        if not candidates:
            return None
        candidates.sort()
        kb = candidates[0][2]
        e = overrides.get(kb)
        if e is None:
            e = self.get(kb)
        return e

    def _offers_by_seller(self, sellerid: bytes):
        # no plan materializes per-seller offer lists today (the ops
        # that scan them are imprecise and close sequentially), so any
        # scan reaching a worker MUST abort — silently serving an empty
        # list would be a wrong-state apply, not an escape
        raise FootprintEscape(
            f"undeclared offer scan for seller {sellerid.hex()[:16]}")

    def _entries_by_key_prefix(self, prefix: bytes):
        raise FootprintEscape(
            f"undeclared prefix scan: {prefix.hex()[:16]}")


class ClusterResult:
    """What one cluster task brings back to the main thread."""

    __slots__ = ("cluster_id", "records", "delta", "okeys", "vkeys",
                 "header", "op_costs", "span_seconds", "encode_seconds",
                 "native", "batched", "op_kinds", "native_op",
                 "native_code")

    def __init__(self, cluster_id: int):
        self.cluster_id = cluster_id
        # tx index -> (ok, result, meta, meta_bytes, pair_bytes, env_bytes)
        self.records: Dict[int, tuple] = {}
        self.delta: Dict[bytes, object] = {}
        self.okeys: set = set()
        self.vkeys: set = set()
        self.header = None
        self.op_costs: Dict[str, List[float]] = {}
        self.span_seconds = 0.0
        self.encode_seconds = 0.0
        # native-kernel outcome: "hit" (applied by the kernel),
        # "decline:<reason>" (kernel refused, Python applied), or None
        # (kernel never attempted)
        self.native: Optional[str] = None
        # applied as part of a multi-cluster batched kernel crossing
        # (ROADMAP 2d amortized dispatch)
        self.batched = False
        # taxonomy: tx count per kernel-shape kind on a hit, and the
        # (op family, reason slug) of a decline — both feed the
        # per-op-type apply.native.* metric breakout
        self.op_kinds: Dict[str, int] = {}
        self.native_op: Optional[str] = None
        self.native_code: Optional[str] = None


class ParallelApplyManager:
    """Owns the apply worker pool + per-session counters; one per
    Application (mirrors the PR-1 bucket-merge pool pattern)."""

    def __init__(self, app):
        self.app = app
        cfg = app.config
        self.workers = int(getattr(cfg, "PARALLEL_APPLY_WORKERS", 0) or 0)
        parallel_on = bool(getattr(cfg, "PARALLEL_APPLY", False))
        # NATIVE_APPLY=0 is the kernel kill switch: clusters then always
        # run the Python reference apply.  NATIVE_APPLY_INLINE engages
        # the planner+kernel WITHOUT a worker pool (workers 0/1): the
        # kernel is faster even sequentially, and the single-cluster
        # fast path needs no pool at all.
        self.native_wanted = bool(getattr(cfg, "NATIVE_APPLY", True))
        pool_on = parallel_on and self.workers >= 2
        if self.native_wanted and (pool_on or parallel_on and
                                   getattr(cfg, "NATIVE_APPLY_INLINE",
                                           False)):
            # probe (and build, once per process — the .so is cached)
            # up front: a host whose kernel cannot build must not pay
            # the single-cluster planning/snapshot overhead for
            # guaranteed declines
            from .native_apply import kernel_module

            if kernel_module() is None:
                self.native_wanted = False
        inline_native = parallel_on and self.native_wanted and \
            bool(getattr(cfg, "NATIVE_APPLY_INLINE", False))
        self.enabled = pool_on or inline_native
        # opt-in post-apply invariant pass over kernel-applied cluster
        # deltas (ROADMAP 2e): configuring INVARIANT_CHECKS engages it,
        # so chaos runs with INVARIANT_CHECKS=[".*"] cover the native
        # path too.  Packed deltas decode lazily inside the checkers —
        # an operator who opts out of checkers never pays the decode.
        self.native_invariants = bool(
            self.enabled and self.native_wanted
            and getattr(app, "invariants", None) is not None
            and app.invariants.invariants)
        if (self.enabled and self.native_wanted
                and getattr(cfg, "INVARIANT_CHECKS", None)):
            from ..utils.logging import get_logger

            get_logger("Ledger").info(
                "native apply kernel on: INVARIANT_CHECKS %s run per-op "
                "on Python-applied clusters and as a post-apply "
                "cluster-delta pass on kernel-applied clusters "
                "(NATIVE_APPLY=0 to run every checker per-op on every "
                "tx)", cfg.INVARIANT_CHECKS)
        self.executor = None
        if pool_on:
            from concurrent.futures import ThreadPoolExecutor

            self.executor = ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="tx-apply")
        # session counters (main-thread only: updated after joins)
        self.stats = {
            "parallel_closes": 0,
            "sequential_closes": 0,
            "aborts": 0,
            "unplanned": 0,
            "preplan_hits": 0,
            "native_hits": 0,      # clusters applied by the kernel
            "native_declines": 0,  # kernel refused -> Python fallback
            "native_off": 0,       # clusters never offered to the kernel
            "batched_clusters": 0,  # kernel hits via batched crossings
            "escapes": [],  # last few escape reasons, newest last
            "native_decline_reasons": [],  # newest last, bounded
        }
        self.last_plan_stats: dict = {}
        # nomination-time plan cache: the plan is a pure function of
        # (tx set, LCL state) — the fee phase moves balances only, never
        # key sets, sponsors or the order book — so the herder can plan
        # while building its proposal and the close just looks it up.
        # Keyed (contents_hash, prev_ledger_hash); externalized foreign
        # sets miss and plan inside the close.  Main-crank-thread only.
        from collections import OrderedDict

        self._plan_cache: "OrderedDict" = OrderedDict()

    def shutdown(self) -> None:
        if self.executor is not None:
            self.executor.shutdown(wait=True)
        path = getattr(self.app.config, "PARALLEL_APPLY_STATS_FILE", None)
        if path:
            self._append_stats_line(path)

    def _append_stats_line(self, path: str) -> None:
        import json

        line = {k: v for k, v in self.stats.items()
                if k not in ("escapes", "native_decline_reasons")}
        line["escape_reasons"] = list(self.stats["escapes"])[-8:]
        line["native_decline_reasons"] = \
            list(self.stats["native_decline_reasons"])[-8:]
        line["workers"] = self.workers
        line["native"] = self.native_wanted
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(line) + "\n")
        except OSError:
            pass

    # -- planning -----------------------------------------------------------

    def preplan(self, tx_set, root) -> None:
        """Nomination-time planning (herder.trigger_next_ledger): plan
        the node's own proposal against the LCL so the close can skip
        the planning cost when this exact set externalizes."""
        if not self.enabled:
            return
        key = (tx_set.contents_hash(), tx_set.previous_ledger_hash)
        if key in self._plan_cache:
            return
        apply_order = tx_set.txs_in_apply_order()
        if len(apply_order) < 2:
            return
        with LedgerTxn(root) as ltx:
            plan, stats = plan_parallel_apply(
                apply_order, ltx,
                allow_single_native=self.native_wanted)
            ltx.rollback()
        self._plan_cache[key] = (plan, stats)
        while len(self._plan_cache) > 4:
            self._plan_cache.popitem(last=False)

    def plan(self, tx_set, apply_order, ltx) -> Optional[ApplyPlan]:
        cached = self._plan_cache.pop(
            (tx_set.contents_hash(), tx_set.previous_ledger_hash), None)
        if cached is not None:
            plan, stats = cached
            self.stats["preplan_hits"] += 1
            stats = dict(stats, preplanned=True)
        else:
            plan, stats = plan_parallel_apply(
                apply_order, ltx,
                allow_single_native=self.native_wanted)
        self.last_plan_stats = stats
        if plan is None:
            self.stats["unplanned"] += 1
        return plan

    # -- execution ----------------------------------------------------------

    def execute(self, plan: ApplyPlan, ltx, apply_order, verify,
                invariant_check) -> Optional[List[tuple]]:
        """Run the plan; on success merge cluster deltas into ``ltx``
        (canonical cluster order) and return the per-tx records in
        apply order: ``(ok, result, meta, meta_bytes, pair_bytes,
        env_bytes)``.  Returns None on abort — ``ltx`` untouched."""
        tracer = self.app.tracer
        metrics = self.app.metrics
        snapshot = self._build_snapshot(plan, ltx)
        abort = threading.Event()
        parent_token = tracer.current_id()
        # pack clusters into a bounded number of tasks (round-robin by
        # cluster id — deterministic): a 1000-payment close can plan
        # hundreds of two-tx clusters, and one future per cluster would
        # drown the win in submit/teardown overhead.  A single-cluster
        # plan (the kernel's adversarial-ring fast path) and the
        # pool-less native-inline mode run on the close thread instead:
        # one task's pool round-trip buys nothing.
        inline = self.executor is None or len(plan.clusters) == 1
        if inline:
            groups: List[List] = [list(plan.clusters)]
        else:
            n_tasks = min(len(plan.clusters), self.workers * 2)
            groups = [[] for _ in range(n_tasks)]
            for cluster in plan.clusters:
                groups[cluster.cluster_id % n_tasks].append(cluster)
        results: List[Optional[ClusterResult]] = []
        escape: Optional[str] = None

        def _collect(run_group):
            nonlocal escape
            try:
                results.extend(run_group())
            except FootprintEscape as e:
                abort.set()
                escape = escape or str(e)
                results.append(None)
            except Exception as e:  # never let a parallel-only failure
                # kill a close the sequential path would survive; real
                # apply errors (invariant violations…) re-raise there
                abort.set()
                escape = escape or f"worker exception: {e!r}"
                results.append(None)

        if inline:
            for group in groups:
                _collect(lambda g=group: self._run_task(
                    g, snapshot, apply_order, verify, invariant_check,
                    abort, tracer, parent_token))
        else:
            futures = [self.executor.submit(
                self._run_task, group, snapshot, apply_order, verify,
                invariant_check, abort, tracer, parent_token)
                for group in groups]
            for fut in futures:
                _collect(fut.result)
        # a second header writer is a planner invariant violation —
        # detect it BEFORE any delta reaches the close LedgerTxn
        if sum(1 for r in results
               if r is not None and r.header is not None) > 1:
            abort.set()
            escape = escape or "two clusters wrote the header"
        if abort.is_set() or any(r is None for r in results):
            self.stats["aborts"] += 1
            if escape is not None:
                self.stats["escapes"].append(escape)
                del self.stats["escapes"][:-32]
            metrics.counter("apply.parallel.abort").inc()
            from ..utils.logging import get_logger

            get_logger("Ledger").warning(
                "parallel apply aborted (%s); replaying sequentially",
                escape or "worker failure")
            return None

        # merge per-op cost attribution into the close's collector
        from ..utils import tracing

        collector = tracing.op_collector()
        if collector is not None:
            merged: Dict[str, List[float]] = {}
            for res in results:
                for name, (secs, count) in res.op_costs.items():
                    slot = merged.setdefault(name, [0.0, 0])
                    slot[0] += secs
                    slot[1] += count
            for name in sorted(merged):
                secs, count = merged[name]
                collector.add_many(name, secs, int(count))

        # canonical-order merge: cluster deltas are disjoint by
        # construction, so update order cannot change the outcome — but
        # keep it deterministic anyway
        header = None
        for res in sorted(results, key=lambda r: r.cluster_id):
            ltx._delta.update(res.delta)
            ltx._okeys |= res.okeys
            ltx._vkeys |= res.vkeys
            if res.header is not None:
                header = res.header
        if header is not None:
            ltx.set_header(header)

        records: List[tuple] = [None] * len(apply_order)
        for res in results:
            for idx, rec in res.records.items():
                records[idx] = rec
        self.stats["parallel_closes"] += 1
        metrics.counter("apply.parallel.close").inc()
        # native-kernel accounting (main thread, after joins)
        for res in results:
            if res.native == "hit":
                self.stats["native_hits"] += 1
                metrics.counter("apply.native.hit").inc()
                # per-op-type hit attribution (tx-granular: a cluster
                # may mix op families); bounded family — past the cap
                # new kinds collapse into apply.native.hit.other
                for kind in sorted(res.op_kinds):
                    metrics.counter(metrics.bounded_name(
                        "apply.native.hit", str(kind), cap=24)).inc(
                            res.op_kinds[kind])
                if res.batched:
                    self.stats["batched_clusters"] += 1
                    metrics.counter("apply.native.batched_clusters").inc()
            elif res.native is not None:
                self.stats["native_declines"] += 1
                metrics.counter("apply.native.decline").inc()
                # reason x op-type breakout: a decline storm names its
                # exact coverage gap in /metrics instead of hiding
                # behind one opaque counter.  Bounded family: an
                # adversarial op mix can mint unbounded (op, reason)
                # combinations — past the cap they collapse into
                # apply.native.decline.other
                metrics.counter(metrics.bounded_name(
                    "apply.native.decline",
                    f"{res.native_op or 'cluster'}."
                    f"{res.native_code or 'unknown'}", cap=48)).inc()
                self.stats["native_decline_reasons"].append(
                    res.native[len("decline:"):])
                del self.stats["native_decline_reasons"][:-32]
            else:
                self.stats["native_off"] += 1
                metrics.counter("apply.native.fallback").inc()
        encode_ms = sum(r.encode_seconds for r in results) * 1000.0
        self.last_plan_stats = dict(self.last_plan_stats,
                                    native_encode_ms=round(encode_ms, 3))
        return records

    # -- internals ----------------------------------------------------------

    def _build_snapshot(self, plan: ApplyPlan, ltx) -> ApplySnapshot:
        store: Dict[bytes, object] = {}
        for cluster in plan.clusters:
            for kb in cluster.keys:
                if kb not in store:
                    store[kb] = ltx.get(kb)
        books = {pair: mat.offers
                 for pair, mat in plan.context.books.items()}
        header = ltx.header()
        pool_quote = bool(getattr(self.app.config, "NATIVE_POOL_QUOTE",
                                  True))
        return ApplySnapshot(store, header, books, header.idPool,
                             pool_quote)

    def _run_task(self, clusters, snapshot, apply_order, verify,
                  invariant_check, abort, tracer,
                  parent_token) -> List["ClusterResult"]:
        """Worker-side: one task runs its packed clusters back to back.

        Runs of kernel-eligible, non-id-pool clusters are coalesced
        into ONE batched kernel crossing (one encode, one GIL release)
        instead of one call per 2-tx cluster — the amortized-dispatch
        half of ROADMAP 2d.  Everything else goes through the
        per-cluster path unchanged."""
        results: List["ClusterResult"] = []
        batch: List = []

        def run_one(cluster):
            return self._run_cluster(cluster, snapshot, apply_order,
                                     verify, invariant_check, abort,
                                     tracer, parent_token)

        def flush():
            if len(batch) >= 2:
                results.extend(self._run_cluster_batch(
                    list(batch), snapshot, apply_order, verify,
                    invariant_check, abort, tracer, parent_token))
            elif batch:
                results.append(run_one(batch[0]))
            batch.clear()

        for cluster in clusters:
            if self.native_wanted and cluster.kernel_ok and \
                    not cluster.writes_header:
                batch.append(cluster)
            else:
                flush()
                results.append(run_one(cluster))
        flush()
        return results

    def _run_cluster_batch(self, batch, snapshot, apply_order, verify,
                           invariant_check, abort, tracer,
                           parent_token) -> List["ClusterResult"]:
        """One GIL-released kernel crossing for a run of disjoint
        kernel-eligible clusters; on any decline, retry per cluster so
        one poisoned cluster cannot drag its batchmates off the kernel."""
        from .native_apply import (
            KernelDecline, run_clusters_native_batched)

        if abort.is_set():
            raise FootprintEscape("aborted by another cluster")
        total_txs = sum(len(c.indices) for c in batch)
        with tracer.span("ledger.apply.cluster.native.batch",
                         parent=parent_token, clusters=len(batch),
                         txs=total_txs, outcome="hit") as nspan:
            try:
                batch_results = run_clusters_native_batched(
                    batch, snapshot, apply_order, verify, ClusterResult)
            except KernelDecline as e:
                if nspan.args is not None:
                    nspan.args["outcome"] = "decline"
                    nspan.args["reason"] = str(e)
                batch_results = None
        if batch_results is None:
            return [self._run_cluster(c, snapshot, apply_order, verify,
                                      invariant_check, abort, tracer,
                                      parent_token)
                    for c in batch]
        ordered = sorted(batch, key=lambda c: c.cluster_id)
        for cluster, res in zip(ordered, batch_results):
            if self.native_invariants:
                self._check_native_invariants(cluster, snapshot, res)
            # metrics attribution only: apportion the crossing's wall
            # time across its clusters by tx count
            share = nspan.seconds * len(cluster.indices) / total_txs
            res.op_costs = {"native_kernel": [share,
                                              len(cluster.indices)]}
            res.span_seconds = share
            res.batched = True
        return batch_results

    def _run_cluster(self, cluster, snapshot,
                     apply_order, verify, invariant_check, abort,
                     tracer, parent_token) -> ClusterResult:
        """Apply one cluster — native kernel first when eligible, the
        Python reference apply otherwise (and on any kernel decline) —
        pre-encoding meta/result/envelope bytes and post-checking the
        written keys."""
        from ..utils import tracing

        decline_reason = None
        decline_op = decline_code = None
        native_res = None
        if self.native_wanted and cluster.kernel_ok:
            from .native_apply import KernelDecline, run_cluster_native

            with tracer.span("ledger.apply.cluster.native",
                             parent=parent_token,
                             cluster=cluster.cluster_id,
                             txs=len(cluster.indices),
                             outcome="hit") as nspan:
                try:
                    native_res = run_cluster_native(
                        cluster, snapshot, apply_order, verify,
                        ClusterResult)
                except KernelDecline as e:
                    decline_reason = str(e)
                    decline_op, decline_code = e.op, e.code
                    if nspan.args is not None:
                        nspan.args["outcome"] = "decline"
                        nspan.args["reason"] = decline_reason
            if native_res is not None:
                if self.native_invariants:
                    self._check_native_invariants(cluster, snapshot,
                                                  native_res)
                native_res.op_costs = {"native_kernel": [
                    nspan.seconds, len(cluster.indices)]}
                native_res.span_seconds = nspan.seconds
                return native_res

        res = ClusterResult(cluster.cluster_id)
        if decline_reason is not None:
            res.native = f"decline:{decline_reason}"
            res.native_op = decline_op
            res.native_code = decline_code
        view = ClusterView(snapshot, cluster, abort)
        with tracer.span("ledger.apply.cluster", parent=parent_token,
                         cluster=cluster.cluster_id,
                         txs=len(cluster.indices)) as span, \
                tracing.collect_op_costs() as op_costs:
            cluster_ltx = LedgerTxn(view)
            for idx in cluster.indices:
                if abort.is_set():
                    # another cluster escaped: the attempt is doomed,
                    # stop burning GIL time on results that get discarded
                    raise FootprintEscape("aborted by another cluster")
                frame = apply_order[idx]
                ok, result, meta = frame.apply(
                    cluster_ltx, verify=verify,
                    invariant_check=invariant_check)
                with tracing.stopwatch() as sw:
                    pair = frame.result_pair(result)
                    pair_bytes = T.TransactionResultPair.encode(pair)
                    meta_bytes = T.TransactionMeta.encode(meta)
                    env_bytes = T.TransactionEnvelope.encode(frame.envelope)
                res.encode_seconds += sw.seconds
                res.records[idx] = (ok, result, meta, meta_bytes,
                                    pair_bytes, env_bytes)
            self._post_check(cluster, snapshot, cluster_ltx)
            res.delta = cluster_ltx._delta
            res.okeys = cluster_ltx._okeys
            res.vkeys = cluster_ltx._vkeys
            res.header = cluster_ltx._header
            res.op_costs = op_costs.costs
        res.span_seconds = span.seconds
        return res

    def _check_native_invariants(self, cluster, snapshot, res) -> None:
        """Post-apply invariant pass over one kernel-applied cluster's
        delta (ROADMAP 2e): rebuild the layer shape the checkers expect
        — a LedgerTxn whose parent is the cluster's footprint view —
        seed it with the kernel's packed delta (entries decode lazily on
        first checker touch), and run every configured checker once at
        cluster granularity.

        A violation raises through the worker's escape machinery: the
        parallel attempt aborts and the sequential replay re-runs the
        same transactions through the Python reference apply with
        per-op checkers — which either reproduces the violation (a real
        bug: the close crashes, safety-first) or proves the kernel
        diverged (the replay's bytes win)."""
        from ..invariant.manager import InvariantDoesNotHold

        view = ClusterView(snapshot, cluster, None)
        ltx = LedgerTxn(view)
        ltx._delta = dict(res.delta)
        ltx._okeys = set(res.okeys)
        if res.header is not None:
            ltx.set_header(res.header)
        try:
            self.app.invariants.check_on_tx_apply(ltx, None, True)
        except InvariantDoesNotHold as e:
            self.app.metrics.counter("apply.native.invariant-fail").inc()
            raise FootprintEscape(
                f"native cluster invariant: {e}") from e

    @staticmethod
    def _post_check(cluster, snapshot, cluster_ltx) -> None:
        """Write-side guard: every written key must be declared (or a
        fresh offer id), and only the id-pool cluster may touch the
        header."""
        for kb in cluster_ltx._delta:
            if kb in cluster.writes or kb.startswith(VIRTUAL_PREFIX):
                continue
            if _is_fresh_offer_key(kb, snapshot.idpool0):
                continue
            if kb in cluster.keys:
                # declared read written to: safe for THIS cluster's view
                # but the planner treated it as read-only for conflict
                # closure — another cluster may read it.  Escape.
                raise FootprintEscape(
                    f"write to read-declared key: {kb.hex()}")
            raise FootprintEscape(f"undeclared write: {kb.hex()}")
        if cluster_ltx._header is not None and not cluster.writes_header:
            raise FootprintEscape("undeclared header write")
