"""Fuzz-campaign bench on the port, the counterpart of the repository's
``tools/fuzz_bench.py``: throughput, fleet scale and the vectorized quorum
A/B of the seeded fault-schedule fuzzer.

- campaign throughput (schedules/hour) and corpus/novelty stats for the
  ``smoke`` and ``default`` generation profiles;
- the known-bad proof: the injected fork schedule is found (fails),
  ddmin-minimized to its essential events, persisted, and the artifact
  replays to the same failure fingerprint; in a full run also the real
  finding (a ``tx set prev hash mismatch`` crash the grammar surfaced);
- fleet-scale runs: one generated ``fleet``-profile schedule at each
  ``--fleet`` size (default 50 and 100 validators), wall seconds per
  virtual second;
- each fleet run's crank profile (the shared clock's wall by subsystem
  bucket, ``utils.clock.CrankProfiler``) in its row, and a progress line
  on stderr every ``PROGRESS_S`` seconds (the network's virtual seconds
  and buckets so far), so a run cut by a time limit shows how far it got;
- the vectorized-vs-scalar quorum A/B: the same slice-evaluation workload
  timed with ``scp/qset_vector`` enabled then disabled (host numpy; no
  node) — the gate wants >= 2x at 50+ validators.

The networks run once a backend: ``cuda`` (every node's verify batches
through the kernel, tallies on the card) and ``cpu`` (the host tiers) on
the same host, the campaigns on every backend and then the fleet runs,
the backends' order alternating part by part.  Repro artifacts, corpora and slow-close traces go to a
temporary directory, or beside ``--out``'s file.  ``--smoke`` is the
budget-capped gate (a smoke campaign, the known-bad proof, a reduced
A/B); exit status 1 on any problem.

Prints one JSON line a backend's part and the result last; writes the
result to a file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.fuzz_bench [--smoke]
           [--seed0 N] [--fleet N ...] [--skip-fleet] [--skip-ab]
           [--skip-campaigns] [--backend cuda|cpu] [--out PATH]
           [--device cpu]
"""
import argparse
import contextlib
import functools
import os
import sys
import threading
import time

from . import (BACKENDS, add_backend_arg, arm_row, backends, card,
               counting, emit, idle_note, no_gpu, turns, work_dir,
               write_out)

PROG = "python -m stellar_core_tpu_torch.tools.fuzz_bench"
FLEET_SHAPES = {50: (10, 5), 100: (20, 5)}
PROGRESS_S = 300.0   # between a fleet run's progress lines


def _note(msg):
    print(f"[fuzz-bench] {msg}", file=sys.stderr, flush=True)


# -- vectorized-vs-scalar slice-evaluation A/B --------------------------------

def _tiered_qsets(n_orgs: int, per_org: int):
    """Per-node hierarchical_quorum qsets: each validator owns its OWN
    qset object with the same symmetric structure, as ``Simulation.
    add_node`` + ``Slot.qset_from_statement`` produce."""
    from ..scp import local_node as LN
    from ..simulation.simulation import _ids, _seeds

    ids = _ids(_seeds(n_orgs * per_org))
    orgs = [ids[o * per_org:(o + 1) * per_org] for o in range(n_orgs)]

    def mk():
        inner = [LN.make_qset(per_org - (per_org - 1) // 3, members)
                 for members in orgs]
        return LN.make_qset(n_orgs - (n_orgs - 1) // 3, [], inner)

    return ids, {nid: mk() for nid in ids}


def bench_slice_eval(n_orgs: int, per_org: int, rounds: int = 40) -> dict:
    """Time the per-slot quorum workload: each round drifts the vote set
    (an org is late, then shows up), then EVERY node evaluates
    ``is_quorum`` over it with its own qset objects.  Each arm gets one
    untimed warm-up pass: the A/B compares steady-state cost."""
    from ..scp import local_node as LN
    from ..scp import qset_vector

    n = n_orgs * per_org
    ids, qsets = _tiered_qsets(n_orgs, per_org)

    def workload() -> int:
        verdicts = 0
        for r in range(rounds):
            absent = set(ids[(r % n_orgs) * per_org:
                             (r % n_orgs) * per_org + per_org])
            for grow in (absent, set()):
                members = {i for i in ids if i not in grow}
                for nid in ids:  # every node evaluates this vote set
                    own = qsets[nid]
                    verdicts += LN.is_quorum(
                        members, lambda _m, q=own: q, local_qset=own)
        return verdicts

    results = {}
    for which, enabled in (("vectorized", True), ("scalar", False)):
        qset_vector.clear_caches()
        qset_vector.set_enabled(enabled)
        try:
            warm = workload()
            t0 = time.perf_counter()
            verdicts = workload()
            wall = time.perf_counter() - t0
        finally:
            qset_vector.set_enabled(True)
        assert warm == verdicts
        results[which] = {"wall_s": round(wall, 4), "verdicts": verdicts}
    results["evaluations"] = rounds * 2 * n
    results["speedup"] = round(
        results["scalar"]["wall_s"]
        / max(results["vectorized"]["wall_s"], 1e-9), 2)
    results["verdicts_agree"] = (
        results["scalar"]["verdicts"] == results["vectorized"]["verdicts"])
    results["vector_stats"] = dict(qset_vector.stats)
    return results


# -- fleet-scale schedule runs ------------------------------------------------

def _fleet_schedule(seed0: int, n_orgs: int, per_org: int) -> dict:
    """First fleet-profile schedule at/after ``seed0`` whose sampled
    topology matches the requested tier."""
    from ..simulation.fuzz import schedule as S

    for seed in range(seed0, seed0 + 512):
        sched = S.generate_schedule(seed, "fleet")
        topo = sched["topology"]
        if topo.get("n_orgs") == n_orgs and topo.get("per_org") == per_org:
            return sched
    raise RuntimeError(
        f"no fleet schedule with {n_orgs}x{per_org} in 512 seeds")


@contextlib.contextmanager
def crank_profiled(progress_s: float):
    """Inside the block, every network a schedule's topology factory
    builds arms its crank profiler as it is built; yields the list of
    those networks.  Every ``progress_s`` seconds a line on stderr gives
    the newest network's virtual seconds and buckets so far."""
    from ..simulation.fuzz import schedule as S

    real, sims, done = S.topology_factory, [], threading.Event()

    def topology_factory(*args, **kw):
        make = real(*args, **kw)

        def make_profiled():
            sim = make()
            sim.enable_crank_profiler()
            sims.append(sim)
            return sim
        return make_profiled

    def progress():
        while not done.wait(progress_s):
            if sims:
                try:
                    _note(f"progress: {sims[-1].crank_report()}")
                except RuntimeError:   # a bucket added while reading
                    pass

    S.topology_factory = topology_factory
    ticker = threading.Thread(target=progress, daemon=True)
    ticker.start()
    try:
        yield sims
    finally:
        S.topology_factory = real
        done.set()
        ticker.join()


def bench_fleet(run, seed0: int, n_orgs: int, per_org: int) -> dict:
    sched = _fleet_schedule(seed0, n_orgs, per_org)
    with crank_profiled(PROGRESS_S) as sims:
        t0 = time.perf_counter()
        res = run(sched)
        wall = time.perf_counter() - t0
    rep = res.get("report") or {}
    virtual = rep.get("virtual_elapsed_s") or float(sched["duration"])
    return {
        "validators": n_orgs * per_org,
        "schedule_id": res["schedule_id"],
        "seed": sched["seed"],
        "events": [e["kind"] for e in sched["events"]],
        "ok": res["ok"],
        "failure_class": res["failure_class"],
        "fingerprint": res.get("fingerprint"),
        "wall_s": round(wall, 2),
        "virtual_s": virtual,
        "wall_s_per_virtual_s": round(wall / max(virtual, 1e-9), 3),
        "ledgers_closed": rep.get("ledgers_closed"),
        "time_to_heal_s": rep.get("time_to_heal_s"),
        "crank_profile": sims[-1].crank_report(),
    }


# -- the known-bad proof ------------------------------------------------------

def prove_schedule(sched: dict, traces_dir: str, minimize_budget: int = 32,
                   run=None) -> dict:
    """Run one failing schedule through the full pipeline — found ->
    ddmin-minimized -> persisted to ``traces_dir`` -> replayed from the
    artifact — and report every stage's verdict.  ``run`` runs one
    schedule (default: ``runner("cuda", traces_dir)``)."""
    from ..simulation.fuzz import (load_schedule, minimize_schedule,
                                   schedule_id, write_repro)
    from ..simulation.fuzz.minimize import verify_repro

    run = run or runner("cuda", traces_dir)
    found = run(sched)
    proof = {
        "schedule_id": schedule_id(sched),
        "found": not found["ok"],
        "failure_class": found["failure_class"],
        "events_before": len(sched["events"]),
    }
    if found["ok"]:
        return proof
    mini, stats = minimize_schedule(
        sched, target_class=found["failure_class"], run=run,
        max_runs=minimize_budget)
    proof.update({
        "events_after": len(mini["events"]),
        "minimized_events": [e["kind"] for e in mini["events"]],
        "oracle_runs": stats["oracle_runs"],
        "minimized_reproduces": stats["reproduces"],
    })
    if not stats["reproduces"]:
        return proof
    path = write_repro(mini, dict(stats["final_result"], ok=False),
                       out_dir=traces_dir,
                       minimized_from=schedule_id(sched))
    verdict = verify_repro(load_schedule(path), run=run)
    proof.update({
        "repro_file": os.path.basename(path),
        "replay_reproduced": verdict["reproduced"],
        "failure_fingerprint":
            verdict["expected"]["failure_fingerprint"],
    })
    return proof


def prove_known_bad(traces_dir: str, minimize_budget: int = 32,
                    run=None) -> dict:
    from ..simulation.fuzz import known_bad_schedule

    return prove_schedule(known_bad_schedule(), traces_dir, minimize_budget,
                          run)


def real_finding_schedule() -> dict:
    """An actual bug the chaos grammar surfaced: on a deliberately-unsafe
    core-4 (threshold 2), equivocating+silencing one node while an honest
    node is partitioned away forks the network, and a node then applies a
    tx set built on the OTHER branch — ledger close dies with ``tx set
    prev hash mismatch`` (crash:RuntimeError), deterministically."""
    from ..simulation.fuzz import schedule as S

    sched = {
        "fuzz_schema": S.SCHEMA_VERSION,
        "seed": 14,
        "profile": "real-finding",
        "topology": {"kind": "core", "n": 4, "threshold": 2},
        "duration": 14.0,
        "converge_timeout": 20.0,
        "events": [
            {"t": 2.0, "kind": "equivocate", "victim": 2},
            {"t": 2.0, "kind": "silence", "victim": 2},
            {"t": 3.0, "kind": "partition", "groups": [[3], [0, 1]]},
        ],
        "traffic": [],
    }
    S.validate_schedule(sched)
    return sched


def runner(backend: str, traces_dir: str):
    """``run_schedule`` with every node on ``backend``'s device and tiers
    and its slow-close traces in ``traces_dir``."""
    from ..simulation.fuzz import run_schedule

    return functools.partial(run_schedule, TRACE_DIR=traces_dir,
                             **BACKENDS[backend])


def run_campaign(profile: str, count: int, seed0: int, smoke: bool,
                 tmp: str, traces_dir: str, run) -> dict:
    from ..simulation.fuzz import FuzzCampaign

    camp = FuzzCampaign(
        seed0=seed0, profile=profile, schedules=count,
        wall_budget_s=180.0 if smoke else 900.0,
        corpus_dir=os.path.join(tmp, f"corpus-{profile}"),
        traces_dir=traces_dir,
        minimize_budget=16 if smoke else 32, run=run, log=_note)
    return camp.run()


def run_campaigns(backend: str, row: dict, args, tmp: str,
                  traces_dir: str, problems: list) -> None:
    """Campaigns, the known-bad proof (and the real finding) on
    ``backend``'s networks, into ``row``."""
    run = runner(backend, traces_dir)
    profiles = (("smoke", 4),) if args.smoke else \
        (("smoke", 6), ("default", 8))
    row["campaigns"] = {}
    for profile, count in profiles:
        summary = run_campaign(profile, count, args.seed0, args.smoke, tmp,
                               traces_dir, run)
        row["campaigns"][profile] = summary
        for f in summary["failures"]:
            what = ("minimized schedule does not reproduce"
                    if f.get("non_reproducing") else "oracle failure")
            problems.append(
                f"{backend} campaign[{profile}] seed {f['seed']}: "
                f"{what} {f['failure_class']!r}")
    _note(f"{backend}: known-bad proof")
    row["known_bad"] = kb = prove_known_bad(
        traces_dir, 16 if args.smoke else 32, run)
    if not kb["found"]:
        problems.append(f"{backend}: known-bad schedule did not fail its "
                        f"oracles")
    elif not kb.get("minimized_reproduces"):
        problems.append(f"{backend}: known-bad minimized schedule does not "
                        f"reproduce the failure")
    elif not kb.get("replay_reproduced"):
        problems.append(f"{backend}: known-bad repro artifact does not "
                        f"replay to the same fingerprint")
    if not args.smoke:
        _note(f"{backend}: real finding")
        row["real_finding"] = rf = prove_schedule(
            real_finding_schedule(), traces_dir, 32, run)
        if not rf["found"]:
            problems.append(f"{backend}: real-finding schedule did not "
                            f"fail its oracles")
        elif not rf.get("replay_reproduced"):
            problems.append(f"{backend}: real-finding repro artifact does "
                            f"not replay")


def run_fleet(backend: str, row: dict, sizes, seed0: int, traces_dir: str,
              problems: list) -> None:
    """One fleet-profile schedule at each of ``sizes`` validators on
    ``backend``'s network, into ``row``."""
    run = runner(backend, traces_dir)
    row["fleet"] = {}
    for n in sizes:
        _note(f"{backend}: fleet {n}")
        f = bench_fleet(run, seed0, *FLEET_SHAPES[n])
        row["fleet"][str(n)] = f
        if not f["ok"]:
            problems.append(
                f"{backend} fleet {n}-validator schedule "
                f"{f['schedule_id']} failed: {f['failure_class']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="budget-capped gate")
    ap.add_argument("--seed0", type=int, default=9000)
    ap.add_argument("--fleet", type=int, choices=sorted(FLEET_SHAPES),
                    action="append",
                    help="fleet size to run (repeatable; default 50 and "
                         "100)")
    ap.add_argument("--skip-fleet", action="store_true")
    ap.add_argument("--skip-ab", action="store_true")
    ap.add_argument("--skip-campaigns", action="store_true",
                    help="skip the campaigns and the known-bad proof")
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2

    doc = {"bench": "fuzz_campaign", "smoke": bool(args.smoke),
           "card": card(), "backends": arms, "runs": []}
    problems = []
    t_start = time.perf_counter()
    with work_dir("fuzz-bench") as tmp:
        traces_dir = (os.path.dirname(os.path.abspath(args.out))
                      if args.out else os.path.join(tmp, "traces"))
        # each part on every backend back to back, the order alternating
        # part by part (``turns``)
        rows = {b: arm_row(b) for b in arms}
        if not args.skip_campaigns:
            for b in turns(arms, 0):
                with counting(rows[b]):
                    run_campaigns(b, rows[b], args, tmp, traces_dir,
                                  problems)
        fleet = [] if args.smoke or args.skip_fleet else \
            (args.fleet or sorted(FLEET_SHAPES))
        if fleet:
            for b in turns(arms, 1):
                with counting(rows[b]):
                    run_fleet(b, rows[b], fleet, args.seed0, traces_dir,
                              problems)
        for b in arms:
            idle_note(rows[b])
            doc["runs"].append(rows[b])
            emit(rows[b])
        if not args.skip_ab:
            _note("slice-eval A/B")
            doc["slice_eval_ab"] = {
                "50": bench_slice_eval(10, 5,
                                       rounds=10 if args.smoke else 40)}
            if not args.smoke:
                doc["slice_eval_ab"]["100"] = bench_slice_eval(
                    20, 5, rounds=20)
            for tier, ab in doc["slice_eval_ab"].items():
                if not ab["verdicts_agree"]:
                    problems.append(f"A/B at {tier}: vectorized and "
                                    f"scalar verdicts disagree")
                if ab["speedup"] < 2.0:
                    problems.append(
                        f"A/B at {tier}: speedup {ab['speedup']}x < 2x")
    doc["wall_s"] = round(time.perf_counter() - t_start, 1)
    doc["problems"] = problems
    doc["green"] = not problems
    write_out(args.out, doc)
    emit(doc)
    return 0 if doc["green"] else 1


if __name__ == "__main__":
    sys.exit(main())
