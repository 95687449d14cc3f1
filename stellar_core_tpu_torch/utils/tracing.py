"""Flight recorder: hierarchical span tracing for the ledger-close path
(ref the reference node's Tracy zones + LogSlowExecution + libmedida
timers; here one subsystem feeds all three surfaces).

Design
------
- ``tracer.span("ledger.apply.dex")`` is a nestable context manager.
  Nesting is tracked per thread; cross-thread parenting (the bucket
  merge worker pool) passes an explicit ``parent=`` token captured on
  the submitting thread via ``tracer.current_id()``.
- Spans ALWAYS measure (two perf_counter reads — the measurement also
  feeds the per-phase close breakdown, which must work regardless of
  recording); they are only RECORDED into the pending ring when the
  tracer is enabled.  A disabled tracer's span costs ~1µs: no
  allocation beyond one small object, no locks.
- Finished spans land in a bounded pending deque; at every ledger close
  ``commit_close(seq)`` drains it into a CloseRecord, so background
  spans (overlay receive, SCP rounds, bucket merges finishing late)
  attach to the next close.  The ring keeps the last N closes WHOLE.
- The slow-close watchdog fires inside commit_close: a close whose root
  span exceeds the threshold is persisted as Chrome ``trace_event``
  JSON (load in chrome://tracing / Perfetto, or tools/trace_view.py)
  and logged as a one-line summary on the Perf partition.
- ``stopwatch()`` is the sanctioned raw-duration helper for consensus
  modules: the perf_counter reads live HERE (utils/ is outside
  detlint's consensus scan), so instrumentation never needs
  det-wallclock baseline entries.
- Spans are on ``perf_counter``; a device profiler (``torch.profiler``)
  stamps its events on the Unix clock.  Each tracer measures the offset
  between the two once, at construction (``unix_ns``), and an exported
  trace carries its earliest span on the Unix clock (``base_unix_ns``),
  so a persisted slow close can be laid over a device trace.

Per-op-type apply attribution: the close's apply loop installs an op
cost collector (``collect_op_costs``); ``transactions/frame.py`` feeds
it per-operation durations via ``op_collector()`` — a single
thread-local read when inactive.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from time import perf_counter, perf_counter_ns, time_ns
from typing import Dict, List, Optional, Tuple

from .lockdep import register_lock

# pending spans kept between closes; eviction-bounded so a node that
# never closes (or a test hammering spans from many threads) cannot
# grow memory without bound
MAX_PENDING_SPANS = 32768
# spans kept per committed close record (1000-tx closes emit ~1k
# admission spans + phases + aggregates)
MAX_SPANS_PER_CLOSE = 16384
DEFAULT_RING_CLOSES = 8


class Span:
    """One finished (or in-flight) span.  ``seconds`` is valid after
    __exit__ even when the tracer is disabled.

    ``close_seq``: cross-CLOSE parenting for the pipelined close tail —
    a span that runs during ledger N+1 but belongs to ledger N's close
    (deferred commit/meta/gc) carries N here and is routed into N's
    already-committed ring record instead of the pending deque."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "thread_name",
                 "t0", "t1", "args", "close_seq", "_tracer")

    def __init__(self, tracer, name: str, parent_id: Optional[int],
                 args: Optional[dict], close_seq: Optional[int] = None):
        self._tracer = tracer
        self.name = name
        self.parent_id = parent_id
        self.span_id = 0
        self.tid = 0
        self.thread_name = ""
        self.t0 = 0.0
        self.t1 = 0.0
        self.args = args
        self.close_seq = close_seq

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr.enabled:
            self.span_id = tr._next_id()
            th = threading.current_thread()
            self.tid = th.ident or 0
            self.thread_name = th.name
            stack = tr._stack()
            if self.parent_id is None and stack:
                self.parent_id = stack[-1]
            stack.append(self.span_id)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = perf_counter()
        tr = self._tracer
        # pop on span_id alone: a tracer disabled BETWEEN enter and exit
        # (bench's A/B toggle, with worker-pool spans still in flight)
        # must not leak this id onto the thread's stack forever
        if self.span_id:
            stack = tr._stack()
            if stack and stack[-1] == self.span_id:
                stack.pop()
            if tr.enabled:
                tr._record(self)
        return False

    def to_dict(self) -> dict:
        d = {"name": self.name, "id": self.span_id,
             "parent": self.parent_id, "tid": self.tid,
             "thread": self.thread_name,
             "t0": self.t0, "dur_ms": round(self.seconds * 1000.0, 6)}
        if self.args:
            d["args"] = dict(self.args)
        return d


class _Stopwatch:
    """Minimal always-on duration scope: the sanctioned timing primitive
    consensus modules use instead of raw perf_counter reads."""

    __slots__ = ("t0", "seconds")

    def __enter__(self) -> "_Stopwatch":
        self.seconds = 0.0
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = perf_counter() - self.t0
        return False

    def lap(self) -> float:
        """Seconds since the start or the previous lap; the next lap
        counts from now."""
        t = perf_counter()
        seconds, self.t0 = t - self.t0, t
        return seconds


def stopwatch() -> _Stopwatch:
    return _Stopwatch()


# -- per-op-type apply cost collection --------------------------------------

_op_tls = threading.local()


class OpCostCollector:
    """Accumulates (total seconds, count) per operation-type name."""

    def __init__(self):
        self.costs: Dict[str, List[float]] = {}

    def add(self, type_name: str, seconds: float) -> None:
        slot = self.costs.get(type_name)
        if slot is None:
            self.costs[type_name] = [seconds, 1]
        else:
            slot[0] += seconds
            slot[1] += 1

    def add_many(self, type_name: str, seconds: float, count: int) -> None:
        """Fold a pre-aggregated (seconds, count) bucket in — the
        parallel-apply executor merges per-cluster collectors into the
        close's collector this way."""
        slot = self.costs.get(type_name)
        if slot is None:
            self.costs[type_name] = [seconds, count]
        else:
            slot[0] += seconds
            slot[1] += count


def op_collector() -> Optional[OpCostCollector]:
    """The active collector for THIS thread (None almost always — the
    single getattr is the whole disabled-path cost in the op loop)."""
    return getattr(_op_tls, "collector", None)


class _CollectScope:
    def __init__(self, collector: OpCostCollector):
        self.collector = collector

    def __enter__(self) -> OpCostCollector:
        _op_tls.collector = self.collector
        return self.collector

    def __exit__(self, *exc) -> bool:
        _op_tls.collector = None
        return False


def collect_op_costs() -> _CollectScope:
    return _CollectScope(OpCostCollector())


# -- the tracer --------------------------------------------------------------

class CloseRecord:
    """``unix_offset_ns``: the recording tracer's Unix-clock offset
    (``Tracer.unix_offset_ns``), None for a record built by hand."""

    __slots__ = ("seq", "root_id", "duration_s", "spans", "truncated",
                 "unix_offset_ns")

    def __init__(self, seq: int, root_id: int, duration_s: float,
                 spans: List[Span], truncated: int,
                 unix_offset_ns: Optional[int] = None):
        self.seq = seq
        self.root_id = root_id
        self.duration_s = duration_s
        self.spans = spans
        self.truncated = truncated
        self.unix_offset_ns = unix_offset_ns


class Tracer:
    def __init__(self, enabled: bool = True,
                 ring_closes: int = DEFAULT_RING_CLOSES,
                 slow_close_threshold: Optional[float] = None,
                 trace_dir: Optional[str] = None,
                 metrics=None,
                 max_pending: int = MAX_PENDING_SPANS):
        self.enabled = enabled
        self.slow_close_threshold = slow_close_threshold
        self.trace_dir = trace_dir
        self.metrics = metrics
        self._lock = register_lock(threading.Lock(), "tracer")
        self._pending: deque = deque(maxlen=max_pending)  # guarded-by: _lock
        self._ring: deque = deque(maxlen=max(1, ring_closes))
        self._id_counter = 0
        self._tls = threading.local()
        # persisted watchdog traces this process wrote: (seq, path)
        self.slow_close_traces: List[Tuple[int, str]] = []
        # Unix clock (ns) less perf_counter (ns), read once: the profiler
        # stamps device events on the Unix clock, spans use perf_counter
        self.unix_offset_ns = time_ns() - perf_counter_ns()

    def unix_ns(self, t: float) -> int:
        """A ``perf_counter`` reading (a span's ``t0``/``t1``) on the
        Unix clock, in ns."""
        return round(t * 1e9) + self.unix_offset_ns

    # -- span plumbing -------------------------------------------------------

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            self._id_counter += 1
            return self._id_counter

    def _record(self, sp: Span) -> None:
        if sp.close_seq is not None and self._route_late(sp):
            return
        with self._lock:
            self._pending.append(sp)

    def _route_late(self, sp: Span) -> bool:
        """Append a close-tagged span to its (already committed) close
        record in the ring — the pipelined tail's spans finish during
        the NEXT close but belong to ledger ``close_seq``.  False when
        that record does not exist yet (the span finished before
        commit_close ran): the pending drain then files it correctly."""
        with self._lock:
            for rec in reversed(self._ring):
                if rec.seq == sp.close_seq:
                    if len(rec.spans) >= MAX_SPANS_PER_CLOSE:
                        rec.truncated += 1
                    else:
                        rec.spans.append(sp)
                    break
            else:
                return False
        if self.metrics is not None:
            self.metrics.timer(f"span.{sp.name}").update(sp.seconds)
        return True

    def span(self, name: str, parent: Optional[int] = None,
             close_seq: Optional[int] = None, **args) -> Span:
        """Nestable span context manager.  ``parent`` overrides the
        thread-local nesting (cross-thread parenting); ``close_seq``
        routes the finished span into that ledger's close record even
        when it outlives the close (cross-close parenting — the
        pipelined tail)."""
        return Span(self, name, parent, args or None,
                    close_seq=close_seq)

    def current_id(self) -> Optional[int]:
        """Token for cross-thread parenting: the innermost open span on
        THIS thread (None when disabled or at top level)."""
        if not self.enabled:
            return None
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def aggregate_span(self, name: str, parent: Optional[int],
                       t0: float, seconds: float, **args) -> None:
        """Emit a synthetic (already-measured) span — the per-op-type
        apply aggregates."""
        if not self.enabled:
            return
        sp = Span(self, name, parent, args or None)
        sp.span_id = self._next_id()
        th = threading.current_thread()
        sp.tid = th.ident or 0
        sp.thread_name = th.name
        sp.t0 = t0
        sp.t1 = t0 + seconds
        self._record(sp)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- close records -------------------------------------------------------

    def commit_close(self, seq: int, root: Span) -> Optional[CloseRecord]:
        """Drain pending spans into the ring as one close record; run the
        slow-close watchdog.  Called by LedgerManager after every close
        (the root span must already be closed)."""
        if not self.enabled:
            return None
        # drain + ring-append under one lock hold: a tail span finishing
        # concurrently either lands in the pending drain (filed here) or
        # sees the new record and routes itself (_route_late) — never
        # neither, never both
        with self._lock:
            spans = list(self._pending)
            self._pending.clear()
            truncated = 0
            if len(spans) > MAX_SPANS_PER_CLOSE:
                truncated = len(spans) - MAX_SPANS_PER_CLOSE
                spans = spans[-MAX_SPANS_PER_CLOSE:]
            rec = CloseRecord(seq, root.span_id, root.seconds, spans,
                              truncated, self.unix_offset_ns)
            self._ring.append(rec)
            if self.metrics is not None:
                # inside the lock on purpose: a tail span routed into
                # this record by _route_late after the append updates
                # its own timer there — counting it here too would
                # double-sample it
                self._update_span_timers(rec)
        thr = self.slow_close_threshold
        if thr is not None and thr > 0 and root.seconds > thr:
            self._watchdog_fire(rec)
        return rec

    def _update_span_timers(self, rec: CloseRecord) -> None:
        """Span-derived timers in the metrics registry: per close, one
        Timer update per span name with that close's total seconds (the
        Prometheus exposition's ``span.*`` series)."""
        totals: Dict[str, float] = {}
        for sp in rec.spans:
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.seconds
        for name in sorted(totals):
            self.metrics.timer(f"span.{name}").update(totals[name])

    def closes(self) -> List[CloseRecord]:
        with self._lock:
            return list(self._ring)

    def get_close(self, seq: Optional[int] = None) -> Optional[CloseRecord]:
        """The ring record for ledger ``seq`` (latest when None)."""
        recs = self.closes()
        if not recs:
            return None
        if seq is None:
            return recs[-1]
        for rec in reversed(recs):
            if rec.seq == seq:
                return rec
        return None

    # -- the slow-close watchdog ---------------------------------------------

    def _watchdog_fire(self, rec: CloseRecord) -> None:
        from .logging import get_logger

        path = None
        if self.trace_dir is not None:
            import os

            try:
                os.makedirs(self.trace_dir, exist_ok=True)
                path = os.path.join(self.trace_dir,
                                    f"slow-close-{rec.seq}.trace.json")
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(chrome_trace(rec), f)
                os.replace(tmp, path)
                self.slow_close_traces.append((rec.seq, path))
            except OSError:
                path = None
        top = top_spans(rec, k=3)
        summary = ", ".join(f"{name} {ms:.1f}ms" for name, ms, _ in top)
        get_logger("Perf").warning(
            "slow close: ledger %d took %.3fs (threshold %.3fs); "
            "top self-time: %s%s", rec.seq, rec.duration_s,
            self.slow_close_threshold, summary,
            f"; trace persisted to {path}" if path else "")


# -- analysis / export -------------------------------------------------------

def self_times(rec: CloseRecord) -> Dict[int, float]:
    """span_id -> self time (duration minus SAME-THREAD children's).
    Cross-thread children run concurrently with their parent (the
    bucket worker merges routinely outlive the staging bucket phase),
    so subtracting them would drive the parent's self time negative."""
    by_id = {sp.span_id: sp for sp in rec.spans}
    selfs = {sp.span_id: sp.seconds for sp in rec.spans}
    for sp in rec.spans:
        parent = by_id.get(sp.parent_id) if sp.parent_id else None
        if parent is not None and parent.tid == sp.tid:
            selfs[parent.span_id] -= sp.seconds
    return selfs


def top_spans(rec: CloseRecord, k: int = 10
              ) -> List[Tuple[str, float, int]]:
    """Top-k (name, self_ms, count) aggregated by span name."""
    selfs = self_times(rec)
    by_name: Dict[str, List[float]] = {}
    for sp in rec.spans:
        slot = by_name.setdefault(sp.name, [0.0, 0])
        slot[0] += selfs.get(sp.span_id, 0.0)
        slot[1] += 1
    ranked = sorted(by_name.items(),
                    key=lambda kv: (-kv[1][0], kv[0]))[:k]
    return [(name, v[0] * 1000.0, int(v[1])) for name, v in ranked]


def summarize_ring(records: List[CloseRecord], k: int = 10) -> List[dict]:
    """Top-k self-time spans aggregated across a list of close records
    (the /trace/summary endpoint body)."""
    by_name: Dict[str, List[float]] = {}
    for rec in records:
        selfs = self_times(rec)
        for sp in rec.spans:
            slot = by_name.setdefault(sp.name, [0.0, 0])
            slot[0] += selfs.get(sp.span_id, 0.0)
            slot[1] += 1
    ranked = sorted(by_name.items(),
                    key=lambda kv: (-kv[1][0], kv[0]))[:k]
    return [{"name": name, "self_ms": round(v[0] * 1000.0, 3),
             "count": int(v[1])} for name, v in ranked]


def chrome_trace(rec: CloseRecord) -> dict:
    """Chrome ``trace_event`` JSON (the "X" complete-event form), with
    span/parent ids in args so cross-thread parenting survives export.
    Timestamps are µs relative to the record's earliest span; the
    metadata's ``base_unix_ns`` is that span's start on the Unix clock
    (a device profiler's), when the record came from a tracer."""
    if rec.spans:
        base = min(sp.t0 for sp in rec.spans)
    else:
        base = 0.0
    events = []
    for sp in rec.spans:
        ev = {"name": sp.name, "ph": "X", "pid": 1, "tid": sp.tid,
              "ts": round((sp.t0 - base) * 1e6, 3),
              "dur": round(sp.seconds * 1e6, 3),
              "args": {"span_id": sp.span_id,
                       "parent_id": sp.parent_id,
                       "thread": sp.thread_name}}
        if sp.args:
            ev["args"].update({k: v for k, v in sp.args.items()
                               if isinstance(v, (int, float, str, bool))})
        events.append(ev)
    meta = {"ledger": rec.seq,
            "duration_ms": round(rec.duration_s * 1000.0, 3),
            "root_span_id": rec.root_id,
            "truncated_spans": rec.truncated}
    if rec.unix_offset_ns is not None:
        meta["base_unix_ns"] = round(base * 1e9) + rec.unix_offset_ns
    return {"traceEvents": events, "metadata": meta}


# -- access helpers ----------------------------------------------------------

#: shared no-op tracer for components constructed without an Application
NULL_TRACER = Tracer(enabled=False)


def tracer_of(obj) -> Tracer:
    """The tracer owned by ``obj``'s Application, else the null tracer —
    lets deep modules (SCP protocols via their driver) instrument
    without new constructor plumbing."""
    app = getattr(obj, "app", None)
    tr = getattr(app, "tracer", None)
    return tr if tr is not None else NULL_TRACER
