"""ddmin repro minimization: shrink a failing schedule to its
essential events, then shrink parameters, re-running the oracle stack
at every step.

The matcher is the failure CLASS (``ScenarioFailure.failure_class`` or
``crash:<ExcType>``), not the full failure fingerprint: a smaller
schedule legitimately forks at a different slot, but it must keep
failing the SAME oracle to count as the same bug.  The final minimized
schedule is re-run to record ITS fingerprint, and that pair (schedule,
expected class + fingerprint) is what ``write_repro`` persists to
``traces/`` — replaying the artifact must reproduce the exact
fingerprint, deterministically (``tools/fuzz_repro`` checks it).
"""
from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

from . import schedule as S
from .executor import run_schedule

REPRO_SCHEMA = 1


# ---------------------------------------------------------------------------
# ddmin over (event, traffic-phase) atoms
# ---------------------------------------------------------------------------

def _atoms(sched: dict) -> List[tuple]:
    return ([("e", i) for i in range(len(sched.get("events", [])))]
            + [("p", i) for i in range(len(sched.get("traffic", [])))])


def _build(sched: dict, atoms: List[tuple]) -> dict:
    keep_e = {i for k, i in atoms if k == "e"}
    keep_p = {i for k, i in atoms if k == "p"}
    out = dict(sched)
    out["events"] = [e for i, e in enumerate(sched.get("events", []))
                     if i in keep_e]
    out["traffic"] = [p for i, p in enumerate(sched.get("traffic", []))
                      if i in keep_p]
    return out


class _Oracle:
    """Budgeted, memoized reproduces-the-class test."""

    def __init__(self, target_class: str, run: Callable[[dict], dict],
                 max_runs: int):
        self.target_class = target_class
        self.run = run
        self.max_runs = max_runs
        self.runs = 0
        self.cache: Dict[str, bool] = {}

    def __call__(self, sched: dict) -> bool:
        try:
            S.validate_schedule(sched)
        except S.ScheduleError:
            return False
        sid = S.schedule_id(sched)
        hit = self.cache.get(sid)
        if hit is not None:
            return hit
        if self.runs >= self.max_runs:
            return False  # budget exhausted: treat as non-reproducing
        self.runs += 1
        res = self.run(sched)
        ok = res.get("failure_class") == self.target_class
        self.cache[sid] = ok
        return ok


def _ddmin(atoms: List[tuple], test: Callable[[List[tuple]], bool]
           ) -> List[tuple]:
    """Classic Zeller/Hildebrandt ddmin to a 1-minimal atom subset."""
    n = 2
    while len(atoms) >= 2:
        chunk = max(1, len(atoms) // n)
        reduced = False
        for start in range(0, len(atoms), chunk):
            complement = atoms[:start] + atoms[start + chunk:]
            if complement and test(complement):
                atoms = complement
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if n >= len(atoms):
                break
            n = min(len(atoms), n * 2)
    return atoms


# ---------------------------------------------------------------------------
# parameter shrinking
# ---------------------------------------------------------------------------

def _shrink_candidates(sched: dict):
    """Yield (description, candidate) parameter-shrunk variants, each a
    single independent change (accepted shrinks re-enter the loop)."""
    # 1. duration down to the last event + slack
    tmax = max([e["t"] for e in sched.get("events", [])]
               + [p["t"] + p["duration"]
                  for p in sched.get("traffic", [])] + [2.0])
    short = round(tmax + 3.0, 1)
    if short < sched["duration"]:
        cand = dict(sched)
        cand["duration"] = short
        yield ("duration", cand)
    # 2. traffic rates halved, phases shortened
    for i, p in enumerate(sched.get("traffic", [])):
        if p["rate"] > 1.0:
            cand = dict(sched)
            cand["traffic"] = list(sched["traffic"])
            cand["traffic"][i] = dict(p, rate=round(p["rate"] / 2, 1))
            yield (f"traffic[{i}].rate", cand)
        if p["duration"] > 2.0:
            cand = dict(sched)
            cand["traffic"] = list(sched["traffic"])
            cand["traffic"][i] = dict(
                p, duration=round(p["duration"] / 2, 1))
            yield (f"traffic[{i}].duration", cand)
    # 3. victim-set shrinking: drop one member of any list param
    for i, e in enumerate(sched.get("events", [])):
        if e["kind"] == "partition":
            for gi, g in enumerate(e["groups"]):
                if len(g) <= 1:
                    continue
                for vi in range(len(g)):
                    cand = dict(sched)
                    cand["events"] = list(sched["events"])
                    groups = [list(x) for x in e["groups"]]
                    groups[gi] = g[:vi] + g[vi + 1:]
                    cand["events"][i] = dict(e, groups=groups)
                    yield (f"events[{i}].groups[{gi}]", cand)
        elif e["kind"] == "flaky" and len(e.get("victims", [])) > 1:
            for vi in range(len(e["victims"])):
                cand = dict(sched)
                cand["events"] = list(sched["events"])
                cand["events"][i] = dict(
                    e, victims=(e["victims"][:vi]
                                + e["victims"][vi + 1:]))
                yield (f"events[{i}].victims", cand)
    # 4. validator-count shrinking (keep every referenced index valid)
    topo = sched["topology"]
    refs = _max_node_ref(sched)
    if topo["kind"] == "core" and topo["n"] > max(3, refs + 1):
        cand = dict(sched)
        cand["topology"] = dict(topo, n=topo["n"] - 1)
        thr = topo.get("threshold")
        if thr is not None and thr > topo["n"] - 1:
            cand["topology"]["threshold"] = topo["n"] - 1
        yield ("topology.n", cand)
    if topo["kind"] == "tiered" and topo["n_orgs"] > 2 \
            and (topo["n_orgs"] - 1) * topo["per_org"] > refs:
        cand = dict(sched)
        cand["topology"] = dict(topo, n_orgs=topo["n_orgs"] - 1)
        yield ("topology.n_orgs", cand)


def _max_node_ref(sched: dict) -> int:
    refs = [-1]
    for e in sched.get("events", []):
        for k in ("victim", "attacker"):
            if k in e:
                refs.append(int(e[k]))
        for g in e.get("groups", []):
            refs.extend(int(v) for v in g)
        refs.extend(int(v) for v in e.get("victims", []))
    return max(refs)


# ---------------------------------------------------------------------------
# the minimizer
# ---------------------------------------------------------------------------

def minimize_schedule(sched: dict, target_class: Optional[str] = None,
                      run: Callable[[dict], dict] = run_schedule,
                      max_runs: int = 48,
                      log: Optional[Callable[[str], None]] = None
                      ) -> Tuple[dict, dict]:
    """Shrink ``sched`` to a 1-minimal failing schedule.

    Returns ``(minimized, stats)`` where stats records the run budget
    spent and the atom counts before/after.  Raises ``ValueError``
    when the input schedule does not fail at all (nothing to
    minimize)."""
    say = log or (lambda s: None)
    first = run(sched)
    if first.get("ok"):
        raise ValueError(
            f"schedule {S.schedule_id(sched)} passes its oracles — "
            f"nothing to minimize")
    target = target_class or first["failure_class"]
    oracle = _Oracle(target, run, max_runs)
    oracle.cache[S.schedule_id(sched)] = \
        first["failure_class"] == target
    atoms0 = _atoms(sched)

    say(f"[ddmin] {len(atoms0)} atoms, class {target!r}")
    atoms = _ddmin(atoms0, lambda a: oracle(_build(sched, a)))
    cur = _build(sched, atoms)

    # parameter shrinking to fixpoint (budget-capped by the oracle)
    changed = True
    while changed and oracle.runs < max_runs:
        changed = False
        for what, cand in _shrink_candidates(cur):
            if oracle(cand):
                say(f"[shrink] {what}")
                cur = cand
                changed = True
                break

    # record the minimized schedule's OWN failure identity (the repro
    # artifact's replay-identity contract)
    final = run(cur)
    stats = {
        "target_class": target,
        "oracle_runs": oracle.runs + 2,
        "atoms_before": len(atoms0),
        "atoms_after": len(_atoms(cur)),
        "reproduces": final.get("failure_class") == target,
        "final_result": {k: final.get(k) for k in
                         ("failure_class", "failure_fingerprint",
                          "schedule_id", "error")},
    }
    return cur, stats


# ---------------------------------------------------------------------------
# repro artifacts (traces/)
# ---------------------------------------------------------------------------

def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_-]+", "-", s)[:40]


def write_repro(sched: dict, result: dict,
                out_dir: str = "traces",
                minimized_from: Optional[str] = None) -> str:
    """Persist one runnable repro artifact.  ``result`` must be the
    schedule's own (failing) run result: its class + fingerprint are
    the expectation ``tools.fuzz_repro`` replays against."""
    assert not result.get("ok"), "repro artifacts are for failures"
    doc = {
        "fuzz_repro_schema": REPRO_SCHEMA,
        "schedule": sched,
        "expect": {
            "failure_class": result["failure_class"],
            "failure_fingerprint": result["failure_fingerprint"],
        },
        "minimized_from": minimized_from,
    }
    os.makedirs(out_dir, exist_ok=True)
    name = (f"FUZZ_REPRO_{_slug(result['failure_class'])}_"
            f"{S.schedule_id(sched)}.json")
    path = os.path.join(out_dir, name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def verify_repro(doc: dict,
                 run: Callable[[dict], dict] = run_schedule) -> dict:
    """Replay one repro doc and check replay identity.  Returns
    ``{"reproduced": bool, "expected": ..., "got": ...}``."""
    if doc.get("fuzz_repro_schema") != REPRO_SCHEMA:
        raise S.ScheduleError(
            f"unknown fuzz_repro_schema "
            f"{doc.get('fuzz_repro_schema')!r}")
    sched = doc.get("schedule")
    S.validate_schedule(sched)
    expect = doc.get("expect") or {}
    res = run(sched)
    got = {"failure_class": res.get("failure_class"),
           "failure_fingerprint": res.get("failure_fingerprint")}
    return {
        "reproduced": (not res.get("ok")
                       and got["failure_class"]
                       == expect.get("failure_class")
                       and got["failure_fingerprint"]
                       == expect.get("failure_fingerprint")),
        "expected": expect,
        "got": got,
        "error": res.get("error"),
    }
