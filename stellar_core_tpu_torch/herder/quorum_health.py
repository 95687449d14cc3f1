"""Quorum-health monitor: continuous evaluation of the live qset graph.

PR 10's vitals answer "is this NODE drifting"; nothing answered "is
this node's QUORUM drifting" — validators silently dropping out of a
slice, a silent set growing v-blocking (one more loss and the node can
neither accept nor abort), or a network whose announced qsets stopped
enjoying intersection.  This monitor runs one cheap evaluation per
closed ledger over the slot's heard envelopes and the local quorum
set, plus an optional budget-capped quorum-intersection scan every N
ledgers, and exports everything as ``quorum.health.*`` gauges (JSON +
Prometheus ``/metrics``), the ``quorum-health`` admin endpoint, and an
SLO hook in the PR-10 vitals watchdog (``SLO_QUORUM_AVAILABILITY``:
a sample taken while the local slice is unsatisfiable from
recently-heard nodes is a breach episode).

Per close (all O(|qset|) with top-level-slice checks):
  heard / heard_fraction   local-qset members with envelopes this slot
  available                is_quorum_slice(qset, heard) — can my own
                           slice still be satisfied by live nodes
  silent_v_blocking        the SILENT set is v-blocking: every quorum
                           of mine needs at least one node that is not
                           talking — the stall precursor
  critical                 heard members whose single loss would flip
                           ``available`` off (node criticality)
  tracked / missing_qsets  transitive-quorum bookkeeping (QuorumTracker)

The monitor only READS consensus state and writes metrics/logs — it
feeds nothing back (same inertness contract as the SCP timeline
recorder, and the same telemetry-on/off bit-identity tests cover it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..scp.local_node import is_quorum_slice, is_v_blocking, qset_nodes


class QuorumHealthMonitor:
    def __init__(self, herder):
        self.herder = herder
        self.app = herder.app
        cfg = self.app.config
        self.enabled = bool(getattr(cfg, "QUORUM_HEALTH_ENABLED", True))
        self.intersection_period = int(getattr(
            cfg, "QUORUM_HEALTH_INTERSECTION_PERIOD", 0))
        self.intersection_max_calls = int(getattr(
            cfg, "QUORUM_HEALTH_INTERSECTION_MAX_CALLS", 200_000))
        self.intersection_timeout = float(getattr(
            cfg, "QUORUM_HEALTH_INTERSECTION_TIMEOUT_SECONDS", 1.0))
        self.last: Optional[dict] = None
        self.last_intersection: Optional[dict] = None
        self.evaluations = 0
        self.last_eval_time = 0.0
        self._warned_unavailable = False

    # -- per-close evaluation ----------------------------------------------

    def on_ledger_closed(self, seq: int) -> None:
        if not self.enabled:
            return
        self.evaluate(seq)
        if self.intersection_period > 0 and \
                seq % self.intersection_period == 0:
            self.check_intersection(seq)

    def _heard_nodes(self, seq: int) -> Set[bytes]:
        """Nodes whose envelopes (either protocol) this node recorded
        for the slot, plus self — the 'recently live' set."""
        scp = self.herder.scp
        heard: Set[bytes] = {scp.local_node.node_id}
        slot = scp.get_slot(seq, create=False)
        if slot is not None:
            heard.update(slot.ballot.latest_envelopes)
            heard.update(slot.nomination.latest_nominations)
        return heard

    def evaluate(self, seq: int) -> dict:
        scp = self.herder.scp
        local_id = scp.local_node.node_id
        qset = scp.local_node.qset
        heard = self._heard_nodes(seq)
        members = sorted(qset_nodes(qset))
        heard_members = [n for n in members if n in heard]
        silent = [n for n in members if n not in heard]
        available = is_quorum_slice(qset, heard)
        blocked = is_v_blocking(qset, set(silent))
        critical: List[bytes] = []
        if available:
            for n in heard_members:
                if n == local_id:
                    continue
                if not is_quorum_slice(qset, heard - {n}):
                    critical.append(n)
        qt = self.herder.quorum_tracker
        missing = qt.nodes_missing_qsets()
        rep = {
            "seq": seq,
            "qset_members": len(members),
            "heard": len(heard_members),
            "heard_fraction": round(
                len(heard_members) / len(members), 4) if members else 0.0,
            "available": bool(available),
            "silent": [n.hex()[:8] for n in silent],
            "silent_v_blocking": bool(blocked),
            "critical": [n.hex()[:8] for n in critical],
            "tracked_nodes": len(qt.quorum),
            "missing_qsets": len(missing),
        }
        self.last = rep
        self.evaluations += 1
        self.last_eval_time = self.app.clock.now()
        m = self.app.metrics
        m.counter("quorum.health.evaluations").inc()
        m.gauge("quorum.health.qset-members").set(len(members))
        m.gauge("quorum.health.heard").set(len(heard_members))
        m.gauge("quorum.health.heard-fraction").set(rep["heard_fraction"])
        m.gauge("quorum.health.available").set(1.0 if available else 0.0)
        m.gauge("quorum.health.silent-v-blocking").set(
            1.0 if blocked else 0.0)
        m.gauge("quorum.health.critical-heard").set(len(critical))
        m.gauge("quorum.health.tracked-nodes").set(len(qt.quorum))
        m.gauge("quorum.health.missing-qsets").set(len(missing))
        if not available or blocked:
            if not self._warned_unavailable:
                from ..utils.logging import get_logger

                get_logger("Herder").warning(
                    "quorum health degraded at seq %d: available=%s "
                    "silent_v_blocking=%s silent=%s", seq, available,
                    blocked, ",".join(rep["silent"]) or "-")
            self._warned_unavailable = True
        else:
            self._warned_unavailable = False
        return rep

    # -- budget-capped intersection scan -----------------------------------

    def check_intersection(self, seq: Optional[int] = None) -> dict:
        """One quorum-intersection scan under the monitor's (small)
        budget — 'unknown' past the budget, never a stall.  The admin
        endpoint's full-budget scan stays at quorum?intersection=true."""
        res = self.herder.check_quorum_intersection(
            max_calls=self.intersection_max_calls,
            max_seconds=self.intersection_timeout)
        rep = {
            "seq": seq if seq is not None
            else self.app.ledger_manager.last_closed_seq(),
            "ok": res.ok,
            "aborted": bool(res.aborted),
            "scanned": res.scanned,
            "scc_size": res.scc_size,
            "tier": res.tier,
        }
        if res.split:
            rep["split"] = [[n.hex()[:8] for n in sorted(side)]
                            for side in res.split]
        self.last_intersection = rep
        m = self.app.metrics
        m.counter("quorum.health.intersection-checks").inc()
        # 1 = enjoys intersection, 0 = SPLIT FOUND, -1 = unknown
        m.gauge("quorum.health.intersection").set(
            -1.0 if res.ok is None else (1.0 if res.ok else 0.0))
        if res.ok is False:
            from ..utils.logging import get_logger

            get_logger("Herder").warning(
                "quorum intersection VIOLATED: disjoint quorums %s",
                rep.get("split"))
        return rep

    # -- reporting (the quorum-health endpoint body) -----------------------

    def report(self) -> dict:
        qt = self.herder.quorum_tracker
        return {
            "enabled": self.enabled,
            "evaluations": self.evaluations,
            "intersection_period": self.intersection_period,
            "last": self.last,
            "intersection": self.last_intersection,
            "transitive": {
                "node_count": len(qt.quorum),
                "missing_qsets": [n.hex()[:8] for n in
                                  sorted(qt.nodes_missing_qsets())],
            },
        }
