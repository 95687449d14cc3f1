"""Transaction-lifecycle telemetry: follow ONE transaction across
subsystems (the axis the PR-4 flight recorder cannot see — spans are
per-close and per-subsystem, a tx's journey crosses both).

Every sampled transaction gets monotonic stage stamps as it moves
through the node:

    recv         overlay socket receive (timestamp token captured by the
                 overlay, before admission work starts)
    admit        TransactionQueue.try_add -> PENDING (the sampling gate)
    txset        included in a nominated TxSetFrame
    nominate     the herder handed that proposal to SCP
    externalize  consensus externalized a value carrying the tx
    apply        the close's apply phase finished the tx
    commit       the tx's ledger became DURABLE (SQL committed).  Under
                 the pipelined close this happens on the tail worker
                 DURING ledger N+1 — the stamp carries the originating
                 ledger seq (the PR-9 cross-close token discipline, same
                 reason deferred spans carry ``close_seq``)

Design constraints, in order:

- **Zero consensus surface.**  Stamps are observational; nothing here
  feeds a hash, a tally or an apply decision.  The wallclock reads live
  in THIS module (utils/ is outside detlint's consensus scan and the
  module is sanctioned like utils/tracing.py), so consensus modules
  stamp through ``app.txtracer`` without det-wallclock findings.
- **Bounded memory, deterministic sampling.**  The live map admits
  every ``stride``-th first-seen transaction; when it fills, every
  other tracked tx (insertion order) is dropped and the stride doubles
  — the PR-4 Histogram reservoir discipline applied to in-flight
  tracking.  Which txs get tracked is a pure function of the admission
  sequence, never of hash order or a PRNG.
- **Near-zero disabled cost.**  A disabled tracker's stamp is one
  attribute check; an enabled tracker's stamp for an untracked tx is
  one dict probe.  The soak bench measures the enabled cost A/B
  (SOAK_BENCH ``disabled_cost``: must stay <1% of close p50).

Rollups land in the owning registry as ``txtrace.stage.<a>_to_<b>``
and ``txtrace.e2e.*`` histograms (seconds), so `/metrics` carries them
in both JSON and Prometheus form; the HTTP ``tx/latency`` endpoint
serves the full report (per-stage summaries in ms + the completed-tx
ring).
"""
from __future__ import annotations

import threading
from collections import deque
from time import perf_counter
from typing import Dict, Iterable, List, Optional

from .lockdep import guard_fields, register_lock

#: lifecycle stages in pipeline order ("fee" = the close's fee/seqnum
#: charge phase — stamped per tx whether the batched fee kernel or the
#: per-tx reference loop charged it, so batching keeps attribution)
STAGES = ("recv", "admit", "txset", "nominate", "externalize", "fee",
          "apply", "commit")
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}
#: precomputed histogram names for every ordered stage pair — string
#: building per completed tx was the dominant rollup cost
_PAIR_NAME = {(a, b): f"txtrace.stage.{a}_to_{b}"
              for i, a in enumerate(STAGES)
              for b in STAGES[i + 1:]}

#: in-flight tracked txs before decimation halves the map (each entry
#: is one small dict of <= 7 floats)
DEFAULT_MAX_LIVE = 512
#: completed lifecycle records retained for the tx/latency endpoint
DEFAULT_RING = 256


class TxLifecycleTracker:
    """One per Application; all stamping funnels through here."""

    def __init__(self, metrics=None, enabled: bool = True,
                 max_live: int = DEFAULT_MAX_LIVE,
                 ring: int = DEFAULT_RING):
        if metrics is None:
            from .metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.enabled = enabled
        self.metrics = metrics
        self.max_live = max(2, int(max_live))
        self._lock = register_lock(threading.Lock(), "txtrace")
        # tx hash -> {stage: perf_counter seconds}
        self._live: Dict[bytes, dict] = {}  # guarded-by: _lock
        # completed lifecycle records
        self._ring: deque = deque(maxlen=max(1, int(ring)))  # guarded-by: _lock
        self._stride = 1          # guarded-by: _lock
        self._seen = 0            # guarded-by: _lock
        self._tracked = 0         # guarded-by: _lock
        self._completed = 0       # guarded-by: _lock
        self._decimations = 0     # guarded-by: _lock
        # Histogram objects resolved once per name: the registry's
        # name->metric lookup per completed tx would dominate _finish
        self._hists: Dict[str, object] = {}  # guarded-by: _lock
        guard_fields(self)

    # -- stamping ----------------------------------------------------------

    def note_recv(self) -> Optional[float]:
        """Overlay-receive timestamp token: captured by the overlay
        BEFORE admission work, handed into ``try_add(recv_ts=...)`` so
        the recv->admit delta covers decode + validity + signature
        cost.  None when disabled (callers pass it through blindly)."""
        if not self.enabled:
            return None
        return perf_counter()

    def on_admit(self, tx_hash: bytes,
                 recv_ts: Optional[float] = None) -> None:
        """The sampling gate, at queue admission (PENDING verdicts
        only).  Accepts every ``stride``-th candidate; a full live map
        decimates deterministically (keep every other entry in
        insertion order, double the stride)."""
        if not self.enabled:
            return
        t = perf_counter()
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self._stride:
                return
            if tx_hash in self._live:
                return
            rec = {"admit": t}
            if recv_ts is not None:
                rec["recv"] = recv_ts
            self._live[tx_hash] = rec
            self._tracked += 1
            if len(self._live) >= self.max_live:
                # keep the ODD insertion indices: a phase-shifted
                # systematic sample of the doubled stride that retains
                # the just-admitted tx (even indices would drop the
                # newcomer the moment it was counted as tracked)
                self._live = dict(list(self._live.items())[1::2])
                self._stride *= 2
                self._decimations += 1

    def stamp_frames(self, frames: Iterable, stage: str,
                     seq: Optional[int] = None) -> None:
        """Stamp ``stage`` for every TRACKED frame in ``frames`` (one
        shared timestamp — the stages are close-level events).  The
        ``commit`` stage finalizes the record: per-stage deltas roll
        into the registry histograms and the record (tagged with the
        ORIGINATING ledger ``seq``, even when the pipelined tail runs
        this during ledger N+1) moves to the completed ring."""
        if not self.enabled:
            return
        idx = _STAGE_INDEX[stage]  # KeyError = caller bug, stay loud
        with self._lock:
            if not self._live:
                return
            t = perf_counter()
            final = idx == len(STAGES) - 1
            for frame in frames:
                h = frame.full_hash()
                rec = self._live.get(h)
                if rec is None or stage in rec:
                    continue
                rec[stage] = t
                if final:
                    del self._live[h]
                    self._finish(rec, seq)

    def _hist(self, name: str):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.metrics.histogram(name)
        return h

    def _finish(self, rec: dict, seq: Optional[int]) -> None:
        """guarded-by: _lock — fold one completed lifecycle into the
        per-stage + end-to-end histograms and the completed ring."""
        order = [s for s in STAGES if s in rec]
        prev = None
        for s in order:
            if prev is not None:
                self._hist(_PAIR_NAME[prev, s]).update(
                    rec[s] - rec[prev])
            prev = s
        self._hist("txtrace.e2e.admit_to_commit").update(
            rec["commit"] - rec["admit"])
        if "recv" in rec:
            self._hist("txtrace.e2e.recv_to_commit").update(
                rec["commit"] - rec["recv"])
        self._completed += 1
        # raw stamps only — formatting happens at report time, not on
        # the close/tail thread
        self._ring.append((seq, rec))

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "stride": self._stride,
                "seen": self._seen,
                "tracked": self._tracked,
                "live": len(self._live),
                "completed": self._completed,
                "decimations": self._decimations,
            }

    def report(self, last: int = 16) -> dict:
        """The tx/latency endpoint body: tracker stats, per-stage and
        end-to-end latency summaries (ms), and the most recent
        completed lifecycles."""
        out = self.stats()
        stages: Dict[str, dict] = {}
        for name in sorted(self.metrics._metrics):
            if not name.startswith("txtrace."):
                continue
            h = self.metrics._metrics[name]
            s = h.summary()
            stages[name] = {
                "count": s["count"],
                "p50_ms": round(s["p50"] * 1000.0, 3),
                "p99_ms": round(s["p99"] * 1000.0, 3),
                "mean_ms": round(s["mean"] * 1000.0, 3),
                "max_ms": round(s["max"] * 1000.0, 3),
            }
        with self._lock:
            raw = list(self._ring)[-last:]
        recent: List[dict] = []
        for seq, rec in raw:
            order = [s for s in STAGES if s in rec]
            first = rec[order[0]]
            recent.append({
                "ledger": seq,
                "stages_ms": {s: round((rec[s] - first) * 1000.0, 3)
                              for s in order},
            })
        out["latency"] = stages
        out["recent"] = recent
        return out
