"""Flood-propagation telemetry: per-item hop records across the overlay
(the network axis PR 10's tx-lifecycle tracker cannot see — it follows
one tx through ONE node's subsystems; this follows one flood item
across the gossip fan-out, hop by hop).

Every sampled flood item (the keys Floodgate already dedups on: a
TRANSACTION or SCP_MESSAGE StellarMessage hash) gets a bounded hop
record at each node that tracks it:

    origin       True when this node first broadcast the item itself
                 (loadgen/HTTP tx submit, own SCP emission); False when
                 it arrived from a peer
    from         pid8 of the peer the FIRST copy arrived from (None at
                 the origin)
    first_t      clock stamp of first sight (sim nodes share one
                 VirtualClock, so cross-node deltas are meaningful AND
                 deterministic — the observatory merges on these)
    dups         redundant copies received after the first, with
                 bounded per-link attribution (``dup_links``) and the
                 first-duplicate lag (how far behind the winning path
                 the best redundant path ran)
    forwards     (t, n_peers) per broadcast fan-out event, bounded;
                 ``fanout`` totals the peers this node relayed to

Design constraints, in order (the PR-10 discipline):

- **Zero consensus surface.**  Stamps are observational; nothing here
  feeds a hash, a message send, or an admission verdict.  Clock reads
  live in THIS module (utils/ is outside detlint's consensus scan),
  consensus modules stamp through ``app.floodtracer``.
- **Bounded memory, deterministic sampling.**  The live map admits
  every ``stride``-th first-seen item; when it fills, every other
  tracked item (insertion order) is dropped and the stride doubles.
  Which items get tracked is a pure function of the first-sight
  sequence, never of hash order or a PRNG.  Floodgate GC retires
  tracked records into a bounded completed ring (``on_clear``).
- **Near-zero disabled cost.**  A disabled tracker costs one attribute
  check per flood site; an enabled tracker's stamp for an untracked
  item is one dict probe.

Rollups land in the owning registry so `/metrics` carries them in JSON
and Prometheus form:

    floodtrace.item.dup_lag         seconds each duplicate arrived
                                    behind the first delivery (the
                                    first sample per item is the
                                    first-delivery margin)
    floodtrace.item.fanout          peers relayed to per fan-out event
    floodtrace.item.relay_latency   first-sight -> first-forward
                                    seconds for RELAYED items (this
                                    node's contribution to hop latency)
    floodtrace.link.unique.<pid8>   per-link first-delivery counter
    floodtrace.link.duplicate.<pid8>  per-link redundant-copy counter

The HTTP ``flood`` endpoint serves one hop record (``?hash=``) or the
tracker report; simulation/observatory.py merges every node's records
into network views (coverage percentiles, per-link redundancy).
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Callable, Dict, List, Optional

from .lockdep import guard_fields, register_lock

#: in-flight tracked items before decimation halves the map
DEFAULT_MAX_LIVE = 512
#: retired hop records retained for the flood endpoint / observatory
DEFAULT_RING = 256
#: distinct peers attributed per item's dup_links before "other"
DUP_LINK_CAP = 16
#: forward fan-out events recorded per item
FORWARD_CAP = 8
#: distinct per-link counter families (floodtrace.link.*) per node
LINK_CAP = 16


class FloodPropagationTracker:
    """One per Application; every flood stamp funnels through here."""

    def __init__(self, metrics=None, enabled: bool = True,
                 now: Optional[Callable[[], float]] = None,
                 max_live: int = DEFAULT_MAX_LIVE,
                 ring: int = DEFAULT_RING):
        if metrics is None:
            from .metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.enabled = enabled
        self.metrics = metrics
        # clock injection: sims pass the shared VirtualClock's now so
        # hop stamps are deterministic and cross-node comparable
        self._now = now if now is not None else _time.monotonic
        self.max_live = max(2, int(max_live))
        self._lock = register_lock(threading.Lock(), "floodtrace")
        # msg hash -> hop record dict
        self._live: Dict[bytes, dict] = {}  # guarded-by: _lock
        # retired hop records: (hash, record)
        self._ring: deque = deque(maxlen=max(1, int(ring)))  # guarded-by: _lock
        self._stride = 1          # guarded-by: _lock
        self._seen = 0            # guarded-by: _lock
        self._tracked = 0         # guarded-by: _lock
        self._retired = 0         # guarded-by: _lock
        self._decimations = 0     # guarded-by: _lock
        # metric objects resolved once per name (registry lookup per
        # flood event would dominate the stamp cost)
        self._hists: Dict[str, object] = {}     # guarded-by: _lock
        self._link_counters: Dict[tuple, object] = {}  # guarded-by: _lock
        guard_fields(self)

    # -- stamping ----------------------------------------------------------

    def _admit(self, h: bytes, rec: dict) -> bool:
        """guarded-by: _lock — the first-sight sampling gate.  Accepts
        every ``stride``-th new item; a full live map decimates
        deterministically (keep every other entry in insertion order,
        double the stride)."""
        self._seen += 1
        if (self._seen - 1) % self._stride:
            return False
        if h in self._live:
            return False
        self._live[h] = rec
        self._tracked += 1
        if len(self._live) >= self.max_live:
            # keep the ODD insertion indices: a phase-shifted
            # systematic sample of the doubled stride that retains the
            # just-admitted item
            self._live = dict(list(self._live.items())[1::2])
            self._stride *= 2
            self._decimations += 1
        return True

    def _link_counter(self, pid8: str, new: bool):
        """guarded-by: _lock — cached per-link flood counter, bounded
        through ONE bounded_name family per direction."""
        c = self._link_counters.get((pid8, new))
        if c is None:
            kind = "unique" if new else "duplicate"
            name = self.metrics.bounded_name(
                f"floodtrace.link.{kind}", pid8, cap=LINK_CAP)
            c = self._link_counters[(pid8, new)] = \
                self.metrics.counter(name)
        return c

    def note_recv(self, h: bytes, pid8: str, new: bool, kind: str,
                  seq: int) -> None:
        """One inbound flood copy: ``new`` is the Floodgate verdict.
        First deliveries pass the sampling gate; duplicates stamp only
        already-tracked items (one dict probe otherwise)."""
        if not self.enabled:
            return
        t = self._now()
        with self._lock:
            self._link_counter(pid8, new).inc()
            if new:
                self._admit(h, {
                    "kind": kind, "origin": False, "from": pid8,
                    "seq": seq, "first_t": t, "dups": 0,
                    "dup_links": {}, "dup_first_lag": None,
                    "forwards": [], "fanout": 0})
                return
            rec = self._live.get(h)
            if rec is None:
                return
            rec["dups"] += 1
            lag = t - rec["first_t"]
            if rec["dup_first_lag"] is None:
                rec["dup_first_lag"] = lag
            links = rec["dup_links"]
            key = pid8 if pid8 in links or len(links) < DUP_LINK_CAP \
                else "other"
            links[key] = links.get(key, 0) + 1
            self._hist("floodtrace.item.dup_lag").update(lag)

    def note_origin(self, h: bytes, kind: str, seq: int) -> None:
        """A locally-originated broadcast (own tx submit / own SCP
        emission) — the item's first sight anywhere, gate applies."""
        if not self.enabled:
            return
        t = self._now()
        with self._lock:
            self._admit(h, {
                "kind": kind, "origin": True, "from": None,
                "seq": seq, "first_t": t, "dups": 0, "dup_links": {},
                "dup_first_lag": None, "forwards": [], "fanout": 0})

    def note_forward(self, h: bytes, n_peers: int) -> None:
        """One broadcast fan-out event for a tracked item."""
        if not self.enabled:
            return
        t = self._now()
        with self._lock:
            rec = self._live.get(h)
            if rec is None:
                return
            if not rec["forwards"] and not rec["origin"]:
                self._hist("floodtrace.item.relay_latency").update(
                    t - rec["first_t"])
            rec["fanout"] += n_peers
            if len(rec["forwards"]) < FORWARD_CAP:
                rec["forwards"].append((t, n_peers))
            self._hist("floodtrace.item.fanout").update(n_peers)

    def retire(self, hashes) -> None:
        """Floodgate GC dropped these records (clear_below's on_clear
        hook): move any tracked ones to the completed ring."""
        if not self.enabled:
            return
        with self._lock:
            if not self._live:
                return
            for h in hashes:
                rec = self._live.pop(h, None)
                if rec is not None:
                    self._retired += 1
                    self._ring.append((h, rec))

    def forget_link(self, pid8: str) -> None:
        """Per-connection attribution reset on peer disconnect (the
        reconnect-churn fix): the link's unique/duplicate counters
        restart at zero with the next connection, so dup-rate gauges
        describe the CURRENT link, not every connection that ever
        carried the peer id."""
        with self._lock:
            for new in (True, False):
                c = self._link_counters.get((pid8, new))
                if c is not None:
                    c.set_count(0)

    def _hist(self, name: str):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.metrics.histogram(name)
        return h

    # -- reporting ---------------------------------------------------------

    @staticmethod
    def _fmt(h: bytes, rec: dict) -> dict:
        """One hop record as a deterministic, jsonable dict."""
        return {
            "hash": h.hex(),
            "kind": rec["kind"],
            "origin": rec["origin"],
            "from": rec["from"],
            "seq": rec["seq"],
            "first_t": round(rec["first_t"], 6),
            "dups": rec["dups"],
            "dup_links": {k: rec["dup_links"][k]
                          for k in sorted(rec["dup_links"])},
            "dup_first_lag": (round(rec["dup_first_lag"], 6)
                              if rec["dup_first_lag"] is not None
                              else None),
            "forwards": [{"t": round(t, 6), "n": n}
                         for t, n in rec["forwards"]],
            "fanout": rec["fanout"],
        }

    def lookup(self, h: bytes) -> Optional[dict]:
        """The flood?hash= body: live map first, then the ring."""
        with self._lock:
            rec = self._live.get(h)
            if rec is not None:
                return self._fmt(h, rec)
            for rh, rec in reversed(self._ring):
                if rh == h:
                    return self._fmt(h, rec)
        return None

    def export(self) -> Dict[str, dict]:
        """Every retained hop record (live + ring), hash-hex keyed and
        sorted — the observatory's per-node raw material."""
        with self._lock:
            items = [(h, rec) for h, rec in self._ring]
            items += list(self._live.items())
        return {h.hex(): self._fmt(h, rec)
                for h, rec in sorted(items, key=lambda kv: kv[0])}

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "stride": self._stride,
                "seen": self._seen,
                "tracked": self._tracked,
                "live": len(self._live),
                "retired": self._retired,
                "decimations": self._decimations,
            }

    def report(self, last: int = 16) -> dict:
        """The flood endpoint body (no ?hash=): tracker stats, the
        floodtrace.* rollup summaries (ms), per-link counters, and the
        most recent hop records."""
        out = self.stats()
        rollups: Dict[str, dict] = {}
        links: Dict[str, dict] = {}
        for name in sorted(self.metrics._metrics):
            if name.startswith("floodtrace.link."):
                parts = name.split(".")  # floodtrace.link.<kind>.<pid8>
                links.setdefault(parts[3], {})[parts[2]] = \
                    self.metrics._metrics[name].count
                continue
            if not name.startswith("floodtrace."):
                continue
            s = self.metrics._metrics[name].summary()
            rollups[name] = {
                "count": s["count"],
                "p50_ms": round(s["p50"] * 1000.0, 3),
                "p99_ms": round(s["p99"] * 1000.0, 3),
                "mean_ms": round(s["mean"] * 1000.0, 3),
                "max_ms": round(s["max"] * 1000.0, 3),
            }
        for pid8, st in links.items():
            uniq = st.get("unique", 0)
            dup = st.get("duplicate", 0)
            st["dup_ratio"] = round(dup / (uniq + dup), 4) \
                if uniq + dup else 0.0
        with self._lock:
            raw = ([(h, rec) for h, rec in self._ring]
                   + list(self._live.items()))[-last:] if last > 0 else []
        out["rollups"] = rollups
        out["links"] = {k: links[k] for k in sorted(links)}
        out["recent"] = [self._fmt(h, rec) for h, rec in raw]
        return out
