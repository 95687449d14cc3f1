"""Pipelined ledger close: overlap ledger N's commit/gc tail with
ledger N+1, and prefetch N+1's footprint keys before its close starts.

After phase 4/5 seal the header (the consensus-visible result: tx
result hash, bucketListHash, skip list), everything that remains of a
close is *durability and bookkeeping*: the SQL commit of the entry
delta + header + tx history, the LCL/bucket-state rows, bucket-store
GC, history checkpointing, the meta stream, and the deferred Python
GC.  r08's flight-recorder phase breakdown puts that tail at ~90ms of
a mixed 1000-tx close — the dominant cost once the native apply kernel
took the apply phase to ~44ms.

This module packages that tail as a ``StagedTail`` task on a dedicated
single worker so the herder can trigger ledger N+1 while N's tail
drains.  The contract:

- **Write-ahead overlay**: before the tail is submitted the close
  thread calls ``LedgerTxnRoot.stage_sealed`` — N's sealed delta
  becomes a read overlay (plus entry-cache write-through and the
  header cache), so every read N+1 performs (point gets, offer-book
  scans, prefix scans, planner materialization) sees N's state while
  SQL still holds N-1.  Bucket-tier reads need no overlay: phase 5's
  ``add_batch`` already folded N in.
- **Strict depth-1**: N+1's seal BARRIERS on N's tail having committed
  durably (``barrier``).  At most one sealed-but-uncommitted ledger
  ever exists, so a crash recovers to the last durably committed LCL
  — the same contract the chaos kill-restore scenarios enforce — and
  the overlay never has to stack.
- **One durable transaction**: the tail writes entries, header, tx
  history, LCL and bucket state under ``Database.write_txn`` with a
  single commit, so the durable state is never torn between them.
- **Kill switch**: ``PIPELINED_CLOSE=0`` (config or env) restores the
  fully synchronous close; results are bit-identical either way
  (tests/test_pipelined_close.py holds hashes AND meta bytes).

Footprint prefetch: the herder footprints its own proposal at
nomination (apply/ preplan) — per-frame declared read/write LedgerKey
sets.  ``stage_prefetch`` turns exactly those keys into one batched
``get_entries`` walk over a snapshot of the bloom-indexed bucket tier
on a second worker, issued BEFORE the tx-set build so the walk
overlaps surge pricing/ordering/hashing; ``adopt_prefetch`` folds the
result into the root entry cache right before the preplan.  The
preplan's sponsor-expansion point reads, the close-thread prefetch
phase and the fee/apply loads then all hit the warm cache — with zero
close-thread SQL point reads in BucketListDB mode.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..utils import lockdep, tracing


class TailFailure(RuntimeError):
    """A deferred close tail failed; the node must not keep closing on
    top of a commit that never became durable."""


class StagedTail:
    """Everything ledger N's deferred tail needs, captured on the close
    thread at seal time (bucket/level snapshots included, so the tail
    never reads bucket-list state that N+1 may be mutating)."""

    __slots__ = ("seq", "delta", "header", "lcl_hash", "apply_order",
                 "tx_result_metas", "encoded_rows", "tx_set",
                 "upgrade_metas", "phases", "parent_token",
                 "level_hashes", "sql_ahead_hex", "buckets")

    def __init__(self, seq: int, delta: Dict[bytes, object], header,
                 lcl_hash: bytes, apply_order, tx_result_metas,
                 encoded_rows, tx_set, upgrade_metas, phases: dict,
                 parent_token: Optional[int],
                 level_hashes: List[Tuple[str, str]],
                 sql_ahead_hex: List[str], buckets: list):
        self.seq = seq
        self.delta = delta
        self.header = header
        self.lcl_hash = lcl_hash
        self.apply_order = apply_order
        self.tx_result_metas = tx_result_metas
        self.encoded_rows = encoded_rows
        self.tx_set = tx_set
        self.upgrade_metas = upgrade_metas
        self.phases = phases
        self.parent_token = parent_token
        self.level_hashes = level_hashes
        self.sql_ahead_hex = sql_ahead_hex
        self.buckets = buckets

    def live_hashes(self) -> set:
        """Hex hashes the durable (snapshot) bucket state references —
        the tail's GC pass must never collect these even if N+1's
        spills have already replaced them in the live list."""
        return {hh for pair in self.level_hashes for hh in pair
                if hh != "00" * 32}


class ClosePipeline:
    """Owns the tail/prefetch workers and the depth-1 handshake; one
    per Application (the PR-1 bucket-merge worker-pool pattern)."""

    def __init__(self, app):
        self.app = app
        cfg = app.config
        self.enabled = bool(getattr(cfg, "PIPELINED_CLOSE", False))
        eager = getattr(cfg, "PIPELINED_CLOSE_EAGER_DRAIN", None)
        # test/standalone rigs (MANUAL_CLOSE) drain after every close so
        # their post-close reads keep sequential semantics; real nodes
        # overlap.  Benches/overlap tests opt out explicitly.
        self.eager_drain = (bool(cfg.MANUAL_CLOSE) if eager is None
                            else bool(eager))
        self._lock = lockdep.register_lock(threading.Lock(),
                                           "close_pipeline")
        # the in-flight tail future, depth <= 1
        self._tail = None                        # guarded-by: _lock
        self._tail_seq = 0                       # guarded-by: _lock
        # a failed tail is sticky: every later barrier re-raises until
        # the operator intervenes
        self._failure: Optional[BaseException] = None  # guarded-by: _lock
        self._tail_executor = None
        self._prefetch_executor = None
        self.stats = {
            "tails": 0,
            "tail_failures": 0,
            "eager_drains": 0,
            "barrier_wait_s": 0.0,
            "prefetch_staged": 0,
            "prefetch_keys": 0,
            "prefetch_adopted": 0,
        }
        # test hook: when set, the tail parks on this event BEFORE any
        # SQL — the deterministic "crash inside the pipeline window"
        # seam for tests/test_chaos.py      # guarded-by: _lock
        self._hold: Optional[threading.Event] = None
        self._abandoned = False                  # guarded-by: _lock
        lockdep.guard_fields(self)

    # -- executors (lazy: a disabled pipeline owns no threads) -------------

    def _tails(self):
        if self._tail_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._tail_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="close-tail")
        return self._tail_executor

    def _prefetchers(self):
        if self._prefetch_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="close-prefetch")
        return self._prefetch_executor

    # -- the staged tail ----------------------------------------------------

    def submit_tail(self, st: StagedTail) -> None:
        """Hand ledger N's tail to the worker.  The caller (the close
        thread, at seal) has already barriered on the previous tail, so
        depth is at most one by construction."""
        with self._lock:
            if self._tail is not None:
                raise TailFailure(
                    "close tail submitted with one already in flight "
                    "(depth-1 barrier violated)")
            self._tail_seq = st.seq
            self._tail = self._tails().submit(self._run_tail, st)
        self.stats["tails"] += 1

    def _run_tail(self, st: StagedTail) -> None:
        hold = self._hold
        if hold is not None:
            hold.wait()
            with self._lock:
                if self._abandoned:
                    return
        run_close_tail(self.app, st)

    def barrier(self) -> None:
        """Block until the in-flight tail (if any) is durably committed;
        re-raise its failure.  Called by the NEXT close at seal (the
        depth-1 rule) and by ``drain``.  On success the write-ahead
        overlay is redundant — SQL now answers — and is dropped."""
        with self._lock:
            if self._failure is not None:
                raise TailFailure(
                    f"close tail for ledger {self._tail_seq} failed"
                ) from self._failure
            fut = self._tail
            seq = self._tail_seq
        if fut is None:
            return
        with tracing.stopwatch() as sw:
            try:
                fut.result()
            except BaseException as e:
                with self._lock:
                    self._failure = e
                    self._tail = None
                self.stats["tail_failures"] += 1
                self.app.metrics.counter("ledger.close.tail-failure").inc()
                raise TailFailure(
                    f"close tail for ledger {seq} failed") from e
        self.stats["barrier_wait_s"] += sw.seconds
        with self._lock:
            self._tail = None
            abandoned = self._abandoned
        if not abandoned:
            self.app.ledger_manager.root.clear_pending()

    def drain(self) -> None:
        self.barrier()

    def tail_depth(self) -> int:
        """In-flight deferred tails (0 or 1 by the depth-1 contract) —
        the vitals sampler's pipeline gauge."""
        with self._lock:
            return 0 if self._tail is None else 1

    def crash_abandon(self) -> None:
        """Crash semantics for tests: discard the in-flight tail WITHOUT
        letting it commit (the durable state stays at the last committed
        LCL, exactly what a process kill inside the pipeline window
        leaves behind).  Only meaningful with the ``_hold`` test hook —
        an unheld tail may already have committed, which is the OTHER
        legal crash outcome."""
        with self._lock:
            self._abandoned = True
            hold = self._hold
            fut = self._tail
            self._tail = None
        if hold is not None:
            hold.set()
        if fut is not None:
            try:
                fut.result()
            except Exception:  # detlint: allow(safety-swallow-except)
                pass  # the node is "dead"; nothing to report to it

    def shutdown(self, abandon: bool = False) -> None:
        """Drain (or abandon) and release the workers.  A tail failure
        during shutdown is logged, not raised — shutdown must not mask
        the original teardown path."""
        if abandon:
            self.crash_abandon()
        else:
            try:
                self.drain()
            except TailFailure:
                from ..utils.logging import get_logger

                get_logger("Ledger").error(
                    "close tail failed during shutdown; durable state "
                    "is the last committed LCL")
        if self._tail_executor is not None:
            self._tail_executor.shutdown(wait=True)
            self._tail_executor = None
        if self._prefetch_executor is not None:
            self._prefetch_executor.shutdown(wait=True,
                                             cancel_futures=True)
            self._prefetch_executor = None
        path = getattr(self.app.config, "PIPELINED_CLOSE_STATS_FILE",
                       None)
        if path and self.stats["tails"]:
            self._append_stats_line(path)

    def _append_stats_line(self, path: str) -> None:
        import json

        line = dict(self.stats)
        line["barrier_wait_s"] = round(line["barrier_wait_s"], 6)
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(line) + "\n")
        except OSError:
            pass

    # -- footprint prefetch -------------------------------------------------

    def stage_prefetch(self, frames, root):
        """Nomination-time: batch-load the candidate frames' declared
        LedgerKey sets (the same per-frame read/write derivation the
        footprint planner consumes) through a SNAPSHOT of the
        bloom-indexed bucket tier on the prefetch worker.  Returns a
        future for ``adopt_prefetch``, or None when the pipeline or
        the bucket tier is off.

        The herder calls this with the RAW queue candidates, BEFORE
        the tx-set build — the worker's bucket walk then overlaps the
        surge-pricing/ordering/hashing of the proposal and the
        footprint preplan, whose sponsor-expansion point reads become
        cache hits at adoption."""
        if not self.enabled or not root._bucket_reads_on() or not frames:
            return None
        # snapshot the buckets + their indexes on THIS thread: the
        # worker then never touches the live level list, which the
        # next close's add_batch mutates
        bl = root._bucket_list()
        buckets = bl.snapshot_read_buckets()
        parent = self.app.tracer.current_id()
        self.stats["prefetch_staged"] += 1
        return self._prefetchers().submit(
            self._run_prefetch, bl, buckets, list(frames), parent)

    def _run_prefetch(self, bl, buckets, frames, parent
                      ) -> Tuple[Dict[bytes, object], float]:
        """Worker-side: derive the exact key set and walk the bucket
        snapshot once (one batched bloom walk instead of thousands of
        point probes on the trigger thread); the entries found and the
        walk's seconds."""
        keys: set = set()
        for frame in frames:
            keys.update(frame.keys_to_prefetch())
        with self.app.tracer.span("ledger.close.prefetch.stage",
                                  parent=parent, keys=len(keys)) as sp:
            found = bl.get_entries_from(buckets, sorted(keys))
        return found, sp.seconds

    def adopt_prefetch(self, fut, root) -> int:
        """Fold a staged prefetch into the root entry cache (keys the
        cache/overlays already answer are skipped — those copies are
        newer than the bucket snapshot).  The herder adopts right
        before the preplan; every later read of these keys — sponsor
        expansion, the close's prefetch/fee/apply phases — is then a
        warm-cache hit."""
        if fut is None:
            return 0
        try:
            found, walk_s = fut.result()
        except Exception:
            # a prefetch failure only costs the warm cache; the close's
            # own prefetch phase reloads the keys authoritatively
            self.app.metrics.counter(
                "ledger.close.prefetch-failure").inc()
            return 0
        self.stats["prefetch_keys"] += len(found)
        root.note_bucket_walk(len(found), walk_s)
        n = root.adopt_prefetch(found)
        self.stats["prefetch_adopted"] += n
        self.app.metrics.counter("ledger.close.prefetch-adopted").inc(n)
        return n


def run_close_tail(app, st: StagedTail) -> None:
    """The deferred phases of ledger ``st.seq``, on the tail worker:
    one durable SQL transaction (entries + header + tx history + LCL +
    bucket state), bucket-store GC, history checkpoint/publish, the
    meta stream, deferred Python GC.  Spans carry ``close_seq`` so they
    land in ledger N's trace record even though they run during N+1."""
    lm = app.ledger_manager
    tracer = app.tracer
    db = app.database
    tail_s: Dict[str, float] = {}
    with tracer.span("ledger.close.commit", parent=st.parent_token,
                     close_seq=st.seq) as sp:
        with db.write_txn():
            lm.root.commit_pending_sql(st.delta, st.header)
            lm._store_tx_history(st.seq, st.apply_order,
                                 st.tx_result_metas, st.encoded_rows)
            lm._store_lcl(st.header, lcl_hash=st.lcl_hash, commit=False)
            lm._store_bucket_state(level_hashes=st.level_hashes,
                                   sql_ahead_hex=st.sql_ahead_hex,
                                   commit=False, run_gc=False)
            db.commit()
        app.bucket_manager.gc_unreferenced(extra_live=st.live_hashes())
    tail_s["commit"] = sp.seconds
    # lifecycle stage "commit", cross-close like the deferred spans:
    # this runs DURING ledger N+1 but the stamp (and the completed
    # record) belongs to the ORIGINATING ledger st.seq
    app.txtracer.stamp_frames(st.apply_order, "commit", seq=st.seq)
    with tracer.span("ledger.close.meta", parent=st.parent_token,
                     close_seq=st.seq) as sp:
        hm = app.history_manager
        if hm is not None:
            hm.maybe_queue_history_checkpoint(
                st.seq, level_hashes=st.level_hashes,
                buckets=st.buckets)
            hm.publish_queued_history()
        app.emit_ledger_close_meta(st.header, st.tx_set,
                                   st.tx_result_metas, st.upgrade_metas)
    tail_s["meta"] = sp.seconds
    with tracer.span("ledger.close.gc", parent=st.parent_token,
                     close_seq=st.seq) as sp:
        lm._post_close_gc(st.seq)
    tail_s["gc"] = sp.seconds
    lm._publish_tail_phases(st, tail_s)
