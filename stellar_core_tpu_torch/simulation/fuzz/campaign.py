"""The fuzz campaign loop: generate -> run -> retain novel -> minimize
failures -> persist repros.

Corpus retention is novelty-driven: every run's quantized behavior
signature (``executor.novelty_signature``) is checked against the
signatures already seen; only runs that did something NEW keep their
schedule in the corpus.  That spends the budget on unexplored
interleavings instead of re-proving the same partition/heal shape
forever, and the retained set doubles as the bench's corpus stats.

Failures are minimized with ddmin (budget-capped) and persisted to
``traces/`` as runnable repro artifacts; a failure whose minimized
schedule does NOT reproduce its class is itself a campaign error
(``non_reproducing``) — the red-flag the verify_green fuzz smoke
gates on.
"""
from __future__ import annotations

import os
import time as _wall
from typing import Callable, Dict, List, Optional

from . import schedule as S
from .executor import run_schedule
from .minimize import minimize_schedule, write_repro


class FuzzCampaign:
    def __init__(self, seed0: int, profile: str = "default",
                 schedules: int = 10,
                 wall_budget_s: Optional[float] = None,
                 corpus_dir: Optional[str] = None,
                 traces_dir: str = "traces",
                 minimize_budget: int = 32,
                 run: Callable[[dict], dict] = run_schedule,
                 log: Optional[Callable[[str], None]] = None):
        self.seed0 = int(seed0)
        self.profile = profile
        self.schedules = int(schedules)
        self.wall_budget_s = wall_budget_s
        self.corpus_dir = corpus_dir
        self.traces_dir = traces_dir
        self.minimize_budget = int(minimize_budget)
        self._run = run
        self._log = log or (lambda s: None)
        self.novelty_seen: Dict[str, int] = {}
        self.results: List[dict] = []
        self.failures: List[dict] = []

    def run(self) -> dict:
        # the campaign LOOP runs on wall time by design: its budget and
        # schedules/hour stats are operator-facing harness numbers.
        # Nothing here feeds a schedule or a verdict — each run's
        # replay identity is a pure function of the schedule's seed.
        # detlint: allow(det-wallclock)
        t0 = _wall.monotonic()
        executed = 0
        retained = 0
        for i in range(self.schedules):
            if self.wall_budget_s is not None and \
                    _wall.monotonic() - t0 > self.wall_budget_s:  # detlint: allow(det-wallclock)
                self._log(f"[campaign] wall budget exhausted after "
                          f"{executed} schedules")
                break
            seed = self.seed0 + i
            sched = S.generate_schedule(seed, self.profile)
            res = self._run(sched)
            executed += 1
            self.results.append(res)
            novel = res["novelty"] not in self.novelty_seen
            self.novelty_seen[res["novelty"]] = \
                self.novelty_seen.get(res["novelty"], 0) + 1
            status = "FAIL" if not res["ok"] else \
                ("new" if novel else "seen")
            self._log(f"[campaign] seed {seed} "
                      f"{S.schedule_id(sched)}: {status} "
                      f"({res.get('failure_class') or 'pass'})")
            if novel and self.corpus_dir:
                retained += 1
                S.save_schedule(sched, os.path.join(
                    self.corpus_dir,
                    f"corpus_{S.schedule_id(sched)}.json"))
            if not res["ok"]:
                self._handle_failure(seed, sched, res)
        wall = _wall.monotonic() - t0  # detlint: allow(det-wallclock)
        return {
            "profile": self.profile,
            "seed0": self.seed0,
            "schedules_requested": self.schedules,
            "schedules_executed": executed,
            "wall_s": round(wall, 2),
            "schedules_per_hour": round(executed / wall * 3600.0, 1)
            if wall > 0 else None,
            "unique_novelty": len(self.novelty_seen),
            "retained": retained,
            "failures": self.failures,
            "failure_count": len(self.failures),
        }

    def _handle_failure(self, seed: int, sched: dict,
                        res: dict) -> None:
        self._log(f"[campaign] minimizing seed {seed} "
                  f"({res['failure_class']})")
        entry = {
            "seed": seed,
            "schedule_id": res["schedule_id"],
            "failure_class": res["failure_class"],
            "failure_fingerprint": res["failure_fingerprint"],
        }
        try:
            mini, stats = minimize_schedule(
                sched, target_class=res["failure_class"],
                run=self._run, max_runs=self.minimize_budget,
                log=self._log)
            entry["minimized"] = {
                "schedule_id": S.schedule_id(mini),
                "atoms_before": stats["atoms_before"],
                "atoms_after": stats["atoms_after"],
                "oracle_runs": stats["oracle_runs"],
                "reproduces": stats["reproduces"],
            }
            if stats["reproduces"]:
                entry["repro_path"] = write_repro(
                    mini, stats["final_result"] | {"ok": False},
                    out_dir=self.traces_dir,
                    minimized_from=res["schedule_id"])
            else:
                entry["non_reproducing"] = True
        except Exception as e:  # minimizer bugs must not kill the run
            entry["minimize_error"] = f"{type(e).__name__}: {e}"
            entry["non_reproducing"] = True
        self.failures.append(entry)
