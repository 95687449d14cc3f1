"""Continuous node vitals: the gauges only LONG runs make meaningful.

Every per-close surface so far (flight-recorder spans, close-phase
dicts, bench A/Bs) answers "how fast was that close"; none answers
"is this node drifting" — RSS creeping, fds leaking, the tx queue
aging toward mass bans, GC pauses stretching.  This sampler records a
fixed-size time series of node-health gauges on a periodic timer and
derives a least-squares slope per gauge, so a soak run can assert
"memory slope ≈ 0" instead of eyeballing two RSS numbers.

Per sample (one dict in a bounded ring):
  rss_bytes / open_fds / threads        process health (/proc-backed)
  tx_queue_depth / tx_queue_age_max     admission pressure + aging
  pipeline_tail_depth                   pipelined-close tail in flight
  bucket_entries / bucket_disk_bytes    state-store growth
  verify_cache_hit_rate                 crypto verify-cache efficacy
  prefetch_hit_rate                     root entry-cache prefetch efficacy
  gc_pending                            allocation-counter pressure

GC pauses are recorded via ``gc.callbacks`` (start/stop bracket around
every collection, including the deferred post-close collections) into
the ``vitals.gc.pause`` histogram + per-generation counters.

Surfaces: every numeric gauge mirrors into the metrics registry as a
``vitals.*`` Gauge (JSON `/metrics` + Prometheus exposition), the HTTP
``vitals`` endpoint serves the full report (latest sample, slopes,
SLO state), and ``VITALS_JSONL`` appends one JSON line per sample for
offline analysis of a whole soak.

SLO watchdog (config ``SLO_MAX_*``, each 0 = disabled): memory slope,
close-latency p99 and tx-queue age are checked per sample once the
ring has warmup depth; a breach increments ``slo.breach.<name>`` and
logs ONE structured WARN per breach episode (level transitions, not
per sample — a soak in breach must not drown the log).

Like utils/tracing.py, the wallclock reads live HERE: the module is
detlint-sanctioned (observation-only), consensus code never imports it.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from time import perf_counter
from typing import Dict, List, Optional, Tuple

#: warmup before slope-based SLOs evaluate (a 2-point "slope" is noise)
SLO_WARMUP_SAMPLES = 8

#: sample keys whose drift a slope is computed for
SLOPE_GAUGES = ("rss_bytes", "open_fds", "threads", "tx_queue_depth",
                "bucket_entries", "bucket_disk_bytes")


def rss_bytes() -> int:
    """Current resident set size.  /proc/self/statm is the live value;
    the resource fallback (non-Linux) is the peak, which still bounds a
    leak check from above."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def least_squares_slope(points: List[Tuple[float, float]]) -> float:
    """dv/dt of (t, v) samples by ordinary least squares; 0.0 below two
    points or with a degenerate time axis."""
    n = len(points)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in points) / n
    mv = sum(v for _, v in points) / n
    denom = sum((t - mt) ** 2 for t, _ in points)
    if denom <= 0.0:
        return 0.0
    num = sum((t - mt) * (v - mv) for t, v in points)
    return num / denom


class VitalsSampler:
    """One per Application.  ``start()`` arms the periodic timer and
    registers the GC callback; ``stop()`` reverses both (the callback
    MUST come off ``gc.callbacks`` — it is process-global and a dead
    node's callback would keep timing other nodes' collections)."""

    def __init__(self, app):
        cfg = app.config
        self.app = app
        self.enabled = bool(getattr(cfg, "VITALS_ENABLED", False))
        self.period = float(getattr(cfg, "VITALS_PERIOD_SECONDS", 1.0))
        self.ring: deque = deque(
            maxlen=int(getattr(cfg, "VITALS_RING_SAMPLES", 900)))
        self.jsonl_path = getattr(cfg, "VITALS_JSONL", None)
        self.samples_taken = 0
        self._timer = None
        self._gc_registered = False
        self._gc_tls = threading.local()  # per-thread collection t0
        # SLO name -> currently-in-breach (episode edge detection)
        self._slo_active: Dict[str, bool] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._timer is not None:
            return
        self._register_gc()
        from .clock import VirtualTimer

        self._timer = VirtualTimer(self.app.clock, owner=self.app)
        self._arm()

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._unregister_gc()

    def _arm(self) -> None:
        self._timer.expires_from_now(self.period)
        self._timer.async_wait(self._tick)

    def _tick(self) -> None:
        self.sample_once()
        if self._timer is not None:
            self._arm()

    # -- gc pause accounting (gc.callbacks) --------------------------------

    def _register_gc(self) -> None:
        if self._gc_registered:
            return
        import gc

        gc.callbacks.append(self._on_gc)
        self._gc_registered = True

    def _unregister_gc(self) -> None:
        if not self._gc_registered:
            return
        import gc

        try:
            gc.callbacks.remove(self._on_gc)
        except ValueError:
            pass  # already gone (interpreter teardown ordering)
        self._gc_registered = False

    def _on_gc(self, phase: str, info: dict) -> None:
        """Bracket every collection — including the deferred post-close
        ones the pipelined tail runs on its worker, hence the
        per-THREAD t0 (two threads' collections must not cross-time)."""
        if phase == "start":
            self._gc_tls.t0 = perf_counter()
        elif phase == "stop":
            t0 = getattr(self._gc_tls, "t0", None)
            if t0 is None:
                return
            self._gc_tls.t0 = None
            m = self.app.metrics
            m.histogram("vitals.gc.pause").update(perf_counter() - t0)
            m.counter("vitals.gc.gen%d.collections"
                      % info.get("generation", 0)).inc()

    # -- sampling ----------------------------------------------------------

    def collect(self) -> dict:
        """One gauge sweep.  Everything here must stay cheap enough to
        run at 1 Hz forever — no heap walks, no SQL."""
        import gc

        app = self.app
        q = app.herder.tx_queue
        lm = app.ledger_manager
        bl = app.bucket_manager.bucket_list
        from ..crypto.ed25519 import verify_cache_stats

        hits, misses = verify_cache_stats()
        entries = disk_bytes = 0
        for lv in bl.levels:
            for b in (lv.curr, lv.snap):
                entries += len(b)
                disk_bytes += getattr(b, "size_bytes", 0)
        return {
            "t": round(perf_counter(), 6),
            "rss_bytes": rss_bytes(),
            "open_fds": open_fds(),
            "threads": threading.active_count(),
            "tx_queue_depth": q.size(),
            "tx_queue_age_max": max(
                (a.age for a in q.accounts.values()), default=0),
            "pipeline_tail_depth": lm.pipeline.tail_depth(),
            "bucket_entries": entries,
            "bucket_disk_bytes": disk_bytes,
            "verify_cache_hit_rate": (
                round(hits / (hits + misses), 4)
                if hits + misses else 0.0),
            "prefetch_hit_rate": round(lm.root.prefetch_hit_rate(), 4),
            "gc_pending": sum(gc.get_count()),
        }

    def sample_once(self) -> dict:
        sample = self.collect()
        self.ring.append(sample)
        self.samples_taken += 1
        m = self.app.metrics
        for k, v in sample.items():
            if k != "t" and isinstance(v, (int, float)):
                m.gauge(f"vitals.{k}").set(v)
        if self.jsonl_path:
            self._persist(sample)
        self._check_slos(sample)
        return sample

    def _persist(self, sample: dict) -> None:
        import json

        try:
            with open(self.jsonl_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(sample, sort_keys=True) + "\n")
        except OSError:
            self.jsonl_path = None  # disk gone: stop retrying per sample

    def slope(self, gauge: str, last_fraction: float = 1.0) -> float:
        """Least-squares drift of one gauge in units per second.
        ``last_fraction`` < 1 fits only the newest part of the ring —
        the steady-state view, which startup transients (caches and
        bounded rings still filling toward their caps) would otherwise
        dominate."""
        pts = [(s["t"], float(s[gauge])) for s in self.ring
               if isinstance(s.get(gauge), (int, float))]
        if last_fraction < 1.0 and len(pts) > 2:
            pts = pts[-max(2, int(len(pts) * last_fraction)):]
        return least_squares_slope(pts)

    def slopes(self, last_fraction: float = 1.0) -> Dict[str, float]:
        return {g: round(self.slope(g, last_fraction), 6)
                for g in SLOPE_GAUGES}

    # -- SLO watchdog ------------------------------------------------------

    def _check_slos(self, sample: dict) -> None:
        cfg = self.app.config
        breaches: List[Tuple[str, str]] = []
        slope_cap = getattr(cfg, "SLO_MAX_MEMORY_SLOPE_MB_S", 0.0)
        if slope_cap and len(self.ring) >= 2 * SLO_WARMUP_SAMPLES:
            # newest-half fit with a doubled warmup: the full-ring fit
            # would count the startup transient (caches and bounded
            # rings filling toward their caps) as a leak and flake the
            # soak gate
            sl = self.slope("rss_bytes", last_fraction=0.5)
            if sl > slope_cap * 1e6:
                breaches.append((
                    "memory-slope",
                    f"rss slope {sl / 1e6:.2f} MB/s > {slope_cap} MB/s "
                    f"(tail fit over {len(self.ring) // 2} samples)"))
        p99_cap = getattr(cfg, "SLO_MAX_CLOSE_P99_SECONDS", 0.0)
        if p99_cap:
            t = self.app.metrics._metrics.get("ledger.ledger.close")
            if t is not None and t.count >= SLO_WARMUP_SAMPLES:
                p99 = t.percentile(0.99)
                if p99 > p99_cap:
                    breaches.append((
                        "close-p99",
                        f"close p99 {p99:.3f}s > {p99_cap}s"))
        age_cap = getattr(cfg, "SLO_MAX_QUEUE_AGE", 0)
        if age_cap and sample["tx_queue_age_max"] > age_cap:
            breaches.append((
                "queue-age",
                f"tx queue age {sample['tx_queue_age_max']} ledgers > "
                f"{age_cap}"))
        if getattr(cfg, "SLO_QUORUM_AVAILABILITY", True):
            # fed by the quorum-health monitor (herder/quorum_health.py):
            # a sample taken while the local quorum slice is
            # unsatisfiable from recently-heard nodes is a breach —
            # only once the monitor has actually evaluated
            qh = getattr(getattr(self.app, "herder", None),
                         "quorum_health", None)
            if qh is not None and qh.enabled and qh.evaluations > 0 \
                    and not getattr(cfg, "MANUAL_CLOSE", False):
                # per-close evaluation freezes during a total stall —
                # the primary failure this SLO exists to catch — so
                # once closes are overdue, re-evaluate against the
                # LIVE slot, where the silence actually is
                stale_after = max(
                    4 * getattr(cfg, "EXP_LEDGER_TIMESPAN_SECONDS", 5.0),
                    2 * self.period)
                if self.app.clock.now() - qh.last_eval_time > stale_after:
                    qh.evaluate(
                        self.app.ledger_manager.last_closed_seq() + 1)
            mm = self.app.metrics._metrics
            avail = mm.get("quorum.health.available")
            evals = mm.get("quorum.health.evaluations")
            if avail is not None and evals is not None and \
                    evals.count > 0 and avail.value < 1.0:
                breaches.append((
                    "quorum-availability",
                    "local quorum slice unsatisfiable from "
                    "recently-heard nodes"))
        breached_now = set()
        for name, msg in breaches:
            breached_now.add(name)
            self.app.metrics.counter(f"slo.breach.{name}").inc()
            if not self._slo_active.get(name):
                from .logging import get_logger

                get_logger("Perf").warning("SLO breach [%s]: %s",
                                           name, msg)
            self._slo_active[name] = True
        for name in self._slo_active:
            if name not in breached_now:
                self._slo_active[name] = False

    def breach_counts(self) -> Dict[str, int]:
        out = {}
        for name, metric in sorted(self.app.metrics._metrics.items()):
            if name.startswith("slo.breach."):
                out[name[len("slo.breach."):]] = metric.count
        return out

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """The vitals endpoint body."""
        gc_pause = self.app.metrics._metrics.get("vitals.gc.pause")
        gp = gc_pause.summary() if gc_pause is not None else None
        if gp is not None:
            gp = {"count": gp["count"],
                  "p50_ms": round(gp["p50"] * 1000.0, 3),
                  "p99_ms": round(gp["p99"] * 1000.0, 3),
                  "max_ms": round(gp["max"] * 1000.0, 3)}
        return {
            "enabled": self.enabled,
            "period_s": self.period,
            "samples": len(self.ring),
            "samples_taken": self.samples_taken,
            "latest": dict(self.ring[-1]) if self.ring else None,
            "slopes_per_s": self.slopes(),
            # newest-half fit: steady-state drift with startup
            # transients (rings/caches filling to their caps) excluded
            "slopes_tail_per_s": self.slopes(last_fraction=0.5),
            "slo": {"active": dict(self._slo_active),
                    "breaches": self.breach_counts()},
            "gc_pause": gp,
        }
