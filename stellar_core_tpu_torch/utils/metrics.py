"""Metrics registry: counters, meters, timers, histograms
(ref lib/libmedida + docs/metrics.md; exposed via the admin `metrics`
endpoint like ref src/main/CommandHandler.cpp:116).

Names are dotted triples like the reference's catalog
("ledger.ledger.close", "scp.envelope.receive").
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional


class Counter:
    """Lock-free by design: metric updates are observability-only — a
    lost increment under a GIL-preempted ``+=`` costs one sample, never
    consensus state (COVERAGE.md "Concurrency analysis")."""

    def __init__(self):
        self.count = 0

    def inc(self, n: int = 1):
        self.count += n  # detlint: allow(conc-unguarded-shared)

    def dec(self, n: int = 1):
        self.count -= n  # detlint: allow(conc-unguarded-shared)

    def set_count(self, n: int):
        self.count = n  # detlint: allow(conc-unguarded-shared)


class Gauge:
    """Last-write instantaneous value (vitals samples, derived rates).
    Unlike medida's callback gauges this is push-style: the owner sets
    it when it samples, so reading a snapshot never runs foreign code."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Meter:
    """Event rate tracker (1m EWMA + total count).

    ``one_minute_rate`` decays on READ: an idle meter's rate tends to 0
    with the time since its last mark instead of freezing at the last
    instantaneous value (medida's tickIfNecessary, folded into the
    getter so there is no tick thread)."""

    def __init__(self, clock=None):
        self.count = 0
        self._rate = 0.0
        self._last: Optional[float] = None
        self._clock = clock

    def _now(self) -> float:
        return self._clock.now() if self._clock else time.monotonic()

    def mark(self, n: int = 1):
        # lock-free like Counter: a racing mark can lose one EWMA step
        # or count — an observability sample, never consensus state
        now = self._now()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = n / dt
            alpha = 1 - math.exp(-dt / 60.0)
            self._rate += alpha * (inst - self._rate)  # detlint: allow(conc-unguarded-shared)
        self._last = now  # detlint: allow(conc-unguarded-shared)
        self.count += n  # detlint: allow(conc-unguarded-shared)

    @property
    def one_minute_rate(self) -> float:
        if self._last is None:
            return 0.0
        idle = self._now() - self._last
        if idle <= 0:
            return self._rate
        return self._rate * math.exp(-idle / 60.0)


class Histogram:
    """Streaming histogram (count/min/max/mean/percentiles) over a
    DETERMINISTIC stride-decimation reservoir.

    Medida keeps a uniform random sample; the randomness made two
    identically-driven registries produce different snapshots (and
    tripped the spirit of detlint's determinism discipline).  Instead:
    accept every ``stride``-th update; when the buffer fills, drop every
    other retained sample and double the stride.  The reservoir is a
    uniform systematic sample of the whole update history, bounded to
    [MAX_SAMPLES/2, MAX_SAMPLES], and a pure function of the update
    sequence."""

    MAX_SAMPLES = 1028

    def __init__(self):
        self.count = 0
        self._samples: List[float] = []
        self._stride = 1
        self.min = math.inf
        self.max = -math.inf
        self._sum = 0.0

    def update(self, v: float):
        self.count += 1
        self._sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if (self.count - 1) % self._stride == 0:
            self._samples.append(v)
            if len(self._samples) >= self.MAX_SAMPLES:
                # keep even positions: exactly the samples a doubled
                # stride would have accepted from the start
                del self._samples[1::2]
                self._stride *= 2

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        k = min(int(p * len(s)), len(s) - 1)
        return s[k]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "min": 0.0 if self.count == 0 else self.min,
            "max": 0.0 if self.count == 0 else self.max,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p75": self.percentile(0.75),
            "p99": self.percentile(0.99),
        }


class Timer(Histogram):
    """Histogram of durations (seconds) + rate."""

    def __init__(self, clock=None):
        super().__init__()
        self.meter = Meter(clock)

    def update(self, v: float):
        super().update(v)
        self.meter.mark()

    def time_scope(self):
        return _TimeScope(self)


class _TimeScope:
    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.update(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    def __init__(self, clock=None):
        import threading

        from .lockdep import register_lock

        self._clock = clock
        self._metrics: Dict[str, object] = {}  # guarded-by: _reg_lock
        # bounded-cardinality metric families (bounded_name): family ->
        # admitted member suffixes.  Guarded by _reg_lock.
        self._families: Dict[str, set] = {}
        # registration is the one cross-thread mutation (the pipelined
        # close's tail worker and gc callbacks both register lazily):
        # without the lock, two threads racing the get-then-insert
        # below could each create the metric and one would silently
        # lose its updates.  Reads stay lock-free: iteration always
        # goes through sorted(...) whose list materialization is
        # GIL-atomic.  Re-entrant: any allocation under the lock may
        # start a collection, whose gc callbacks (utils/vitals) register
        # metrics on the same thread; a plain Lock deadlocked there.
        self._reg_lock = register_lock(threading.RLock(), "metrics.registry")

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._reg_lock:
                m = self._metrics.get(name)
                if m is None:
                    # a gc callback inside cls() may register it first
                    m = self._metrics.setdefault(name, cls(*args))
        assert isinstance(m, cls), f"{name} registered as {type(m).__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter, self._clock)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer, self._clock)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def bounded_name(self, family: str, member: str,
                     cap: int = 32) -> str:
        """Bounded-cardinality guard for label-shaped metric families
        (``apply.native.decline.<op>.<why>``, ``overlay.peer.*.<id>``):
        the first ``cap`` DISTINCT members keep their own metric name
        (``family.member``); every later member collapses into
        ``family.other``, so an adversarial label mix (hostile op
        shapes, peer churn) cannot grow the registry — and the
        /metrics payload — without bound.  Admission is deterministic
        first-come.  Member strings are sanitized (dots allowed, other
        separators collapse) so a hostile slug cannot fork families."""
        member = member.replace("\n", "_").replace(" ", "_") or "unknown"
        members = self._families.get(family)
        if members is not None and member in members:
            return f"{family}.{member}"
        with self._reg_lock:
            members = self._families.setdefault(family, set())
            if member in members or len(members) < cap:
                members.add(member)
                return f"{family}.{member}"
        return f"{family}.other"

    def snapshot(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out[name] = {"type": "counter", "count": m.count}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value}
            elif isinstance(m, Timer):
                out[name] = {"type": "timer", **m.summary(),
                             "rate1m": m.meter.one_minute_rate}
            elif isinstance(m, Meter):
                out[name] = {"type": "meter", "count": m.count,
                             "rate1m": m.one_minute_rate}
            elif isinstance(m, Histogram):
                out[name] = {"type": "histogram", **m.summary()}
        return out

    def reset(self) -> None:
        """MetricResetter equivalent for tests."""
        with self._reg_lock:
            self._metrics.clear()
            self._families.clear()


# -- Prometheus exposition ---------------------------------------------------

def _prom_name(name: str) -> str:
    """Dotted medida-style names -> a legal Prometheus metric name."""
    import re

    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", out):
        out = "_" + out
    return out


#: registry families whose last dotted segment is a peer id (pid8 or the
#: bounded_name "other" roll-up) — exposed as a {peer="..."} label
#: instead of a per-peer metric name
_PEER_FAMILIES = ("overlay.peer.", "floodtrace.link.")


def _peer_split(name: str):
    """'overlay.peer.queue_depth.ab12cd34' -> (family, member), else
    None for names outside the per-peer families."""
    for pref in _PEER_FAMILIES:
        if name.startswith(pref):
            fam, _, member = name.rpartition(".")
            if fam != pref.rstrip(".") and member:
                return fam, member
    return None


def render_prometheus(registry: MetricsRegistry) -> str:
    """Text exposition format (version 0.0.4) of the registry: counters
    as ``counter``, meters as count + 1m-rate gauge, timers/histograms
    as ``summary`` with quantile labels — the shape Prometheus's
    text-format parser and promtool both accept.  Span-derived timers
    (``span.*``, fed per close by the flight recorder) ride along as
    ordinary registry timers.

    Per-peer families (overlay.peer.*, floodtrace.link.*) emit one
    metric per family with a ``{peer="..."}`` label rather than
    name-mangling the peer id — sorted iteration keeps a family's
    members adjacent, so each family gets exactly one # TYPE line.  The
    JSON snapshot() form is unchanged."""
    lines: List[str] = []
    typed = set()
    for name, m in sorted(registry._metrics.items()):
        ps = _peer_split(name) if isinstance(m, (Counter, Gauge)) else None
        if ps is not None:
            fam, member = ps
            pname = _prom_name(fam)
            if pname not in typed:
                typed.add(pname)
                lines.append(
                    f"# TYPE {pname} "
                    f"{'counter' if isinstance(m, Counter) else 'gauge'}")
            val = m.count if isinstance(m, Counter) else f"{m.value:.6g}"
            lines.append(f'{pname}{{peer="{member}"}} {val}')
            continue
        pname = _prom_name(name)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {m.count}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {m.value:.6g}")
        elif isinstance(m, Timer):
            _render_summary(lines, pname + "_seconds", m)
            rname = pname + "_rate1m"
            lines.append(f"# TYPE {rname} gauge")
            lines.append(f"{rname} {m.meter.one_minute_rate:.6g}")
        elif isinstance(m, Meter):
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {m.count}")
            rname = pname + "_rate1m"
            lines.append(f"# TYPE {rname} gauge")
            lines.append(f"{rname} {m.one_minute_rate:.6g}")
        elif isinstance(m, Histogram):
            _render_summary(lines, pname, m)
    return "\n".join(lines) + "\n"


def _render_summary(lines: List[str], pname: str, h: Histogram) -> None:
    s = h.summary()
    lines.append(f"# TYPE {pname} summary")
    for q, key in (("0.5", "p50"), ("0.75", "p75"), ("0.99", "p99")):
        lines.append(f'{pname}{{quantile="{q}"}} {s[key]:.6g}')
    lines.append(f"{pname}_sum {h.mean * h.count:.6g}")
    lines.append(f"{pname}_count {h.count}")
