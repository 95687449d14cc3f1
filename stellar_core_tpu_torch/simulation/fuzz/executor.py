"""Schedule executor: compile the IR against the chaos engine and run
it under the full oracle stack.

Every run goes through ``simulation.chaos.run_scenario`` and therefore
inherits the whole safety contract: no forks among honest survivors
(header chain + bucket hash), two-ledger convergence after heal within
the schedule's ``converge_timeout``, time-to-heal, INVARIANT_CHECKS
(sim nodes run ``[".*"]``; a violation raises out of the close), the
unfired-script oracle, and — with traffic phases — loadgen admission
accounting.  On top of that the executor adds the fuzzer's own two:

- ``failure_fingerprint`` — a deterministic hash over the failure
  class + per-node externalize record + first divergence, computed
  from the forensics dump (itself byte-stable across same-seed
  reruns).  The persisted repro's replay-identity check compares THIS,
  so "reproduces" means the same failure at the same slots, not just
  any red run.
- ``novelty`` — a quantized signature over what the run DID (ledgers
  closed, chaos counter profile, heal time bucket, traffic statuses,
  topology/event shape): the corpus-retention signal that keeps the
  campaign spending budget on interleavings it hasn't seen.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

from ...crypto import sha256
from ..chaos import ScenarioFailure, run_scenario
from . import schedule as S


def _compile_events(sched: dict, ids: List[bytes]) -> List[tuple]:
    """IR events -> run_scenario (t, label, fn(chaos)) triples."""
    out = []
    for ev in sched.get("events", []):
        kind = ev["kind"]
        t = float(ev["t"])
        if kind == "partition":
            groups = [[ids[i] for i in g] for g in ev["groups"]]
            fn = lambda c, g=groups: c.partition(g)
        elif kind == "heal":
            fn = lambda c: c.heal()
        elif kind == "clear_links":
            fn = lambda c: c.clear_links()
        elif kind == "flaky":
            victims = [ids[i] for i in ev.get("victims", [])]

            def fn(c, vs=victims, ev=ev):
                for v in vs:
                    for a, b in c.sim.topology:
                        if v in (a, b):
                            c.set_link(
                                a, b, drop=float(ev.get("drop", 0.0)),
                                damage=float(ev.get("damage", 0.0)),
                                duplicate=float(
                                    ev.get("duplicate", 0.0)))
        elif kind == "lag":
            fn = lambda c, v=ids[ev["victim"]], ev=ev: c.lag(
                v, float(ev.get("latency", 1.0)))
        elif kind == "unlag":
            fn = lambda c, v=ids[ev["victim"]]: c.lag(v, 0.0)
        elif kind == "crash":
            fn = lambda c, v=ids[ev["victim"]]: c.crash(v)
        elif kind == "restore":
            fn = lambda c, v=ids[ev["victim"]]: c.restore(v)
        elif kind == "equivocate":
            fn = lambda c, v=ids[ev["victim"]]: c.equivocate(v)
        elif kind == "silence":
            # selective forwarding: the victim keeps emitting its own
            # SCP traffic but relays nothing (the Byzantine-bridge leg
            # of the induced-fork recipe)
            def fn(c, v=ids[ev["victim"]]):
                c.byzantine.add(v)
                c.sim.nodes[v].overlay_manager.broadcast_message = \
                    lambda *a, **kw: None
        elif kind == "capture_scp":
            fn = lambda c, v=ids[ev["victim"]]: c.capture_scp(v)
        elif kind == "replay_stale":
            def fn(c, a=ids[ev["attacker"]], ev=ev):
                lcl = c.sim.nodes[a].ledger_manager.last_closed_seq()
                c.replay_stale(
                    a, max_age_slot=max(1, lcl - int(ev.get("age", 2))),
                    limit=int(ev.get("limit", 64)))
        else:  # pragma: no cover - validate_schedule rejects these
            raise S.ScheduleError(f"unknown event kind {kind!r}")
        out.append((t, f"{kind} {_ev_brief(ev)}".strip(), fn))
    return out


def _ev_brief(ev: dict) -> str:
    parts = [f"{k}={ev[k]}" for k in sorted(ev)
             if k not in ("kind", "t", "groups", "victims")]
    return " ".join(parts)


def _canon(doc) -> bytes:
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()


def failure_fingerprint(failure_class: str,
                        forensics: Optional[dict]) -> str:
    """Deterministic identity of one failure: the class plus the
    divergence shape and per-node externalize record from the
    forensics dump.  Pure function of run state — a same-seed rerun
    reproduces it byte-for-byte."""
    material = {
        "class": failure_class,
        "divergence": (forensics or {}).get("divergence"),
        "first": (forensics or {}).get("first_divergence"),
        "externalized": (forensics or {}).get("per_node_externalized"),
    }
    return sha256(_canon(material)).hex()


def novelty_signature(sched: dict, result: dict) -> str:
    """Quantized behavior signature for corpus retention.  Buckets are
    coarse on purpose: two runs differing only in microsecond timing
    should collide, two runs exercising different fault/traffic
    machinery should not."""
    rep = result.get("report") or {}
    counters = rep.get("counters") or {}
    traffic = rep.get("traffic") or {}
    material = {
        "topology": sched["topology"],
        "kinds": sorted({e["kind"] for e in sched.get("events", [])}),
        "class": result.get("failure_class"),
        "ledgers": (rep.get("ledgers_closed") or 0) // 4,
        "heal_bucket": int(float(rep.get("time_to_heal_s") or 0.0) / 5),
        "counter_profile": sorted(
            k for k, v in counters.items() if v > 0),
        "traffic_statuses": sorted(
            (traffic.get("status_totals") or {}).items()),
        "banned": (traffic.get("queue") or {}).get("banned", 0) > 0,
    }
    return sha256(_canon(material)).hex()[:16]


def run_schedule(sched: dict, persist_dir: Optional[str] = None,
                 forensics_dir: Optional[str] = None, device=None,
                 **config_kw) -> dict:
    """Execute one schedule under the full oracle stack.  ``device`` and
    ``config_kw`` go to every node (``schedule.topology_factory``); a
    caller of ``minimize_schedule``, ``verify_repro`` or ``FuzzCampaign``
    that pins them passes ``functools.partial(run_schedule, ...)`` as its
    ``run``.

    Returns a classified result dict:
    ``{"ok", "schedule_id", "failure_class", "failure_fingerprint",
    "fingerprint", "novelty", "report"|"error"}`` — never raises for
    an oracle failure (the campaign loop and ddmin need red runs as
    DATA); programming errors inside the fuzzer itself still raise.
    """
    S.validate_schedule(sched)
    sid = S.schedule_id(sched)
    ids = S.node_ids(sched["topology"])
    label = f"fuzz-{sid}"

    def _run(workdir: str) -> dict:
        fdir = forensics_dir or workdir
        make_sim = S.topology_factory(sched["topology"], workdir,
                                      device=device, **config_kw)
        events = _compile_events(sched, ids)
        try:
            rep = run_scenario(
                make_sim, int(sched["seed"]), events,
                float(sched["duration"]), label,
                converge_timeout=float(
                    sched.get("converge_timeout", 120.0)),
                forensics_dir=fdir,
                traffic=sched.get("traffic") or None)
        except ScenarioFailure as e:
            forensics = None
            if e.forensics_path and os.path.exists(e.forensics_path):
                with open(e.forensics_path, "r", encoding="utf-8") as f:
                    forensics = json.load(f)
            res = {
                "ok": False, "schedule_id": sid,
                "failure_class": e.failure_class,
                "failure_fingerprint": failure_fingerprint(
                    e.failure_class, forensics),
                "fingerprint": None,
                "error": str(e).splitlines()[0][:400],
            }
            res["novelty"] = novelty_signature(sched, res)
            return res
        except Exception as e:  # invariant violations, close crashes
            cls = f"crash:{type(e).__name__}"
            res = {
                "ok": False, "schedule_id": sid,
                "failure_class": cls,
                "failure_fingerprint": sha256(
                    cls.encode() + str(e)[:500].encode()).hex(),
                "fingerprint": None,
                "error": str(e).splitlines()[0][:400] if str(e)
                else type(e).__name__,
            }
            res["novelty"] = novelty_signature(sched, res)
            return res
        res = {
            "ok": True, "schedule_id": sid,
            "failure_class": None, "failure_fingerprint": None,
            "fingerprint": rep["fingerprint"],
            "report": {
                "ledgers_closed": rep["ledgers_closed"],
                "virtual_elapsed_s": rep["virtual_elapsed_s"],
                "time_to_heal_s": rep["time_to_heal_s"],
                "counters": rep["counters"],
                "fork_comparisons": rep["fork_comparisons"],
                "traffic": rep.get("traffic"),
            },
        }
        res["novelty"] = novelty_signature(sched, res)
        return res

    if persist_dir is not None:
        return _run(persist_dir)
    with tempfile.TemporaryDirectory(prefix="fuzz-sched-") as d:
        return _run(d)
