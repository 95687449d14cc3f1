"""Chaos scenario bench on the port: the scripted fault suite at network
scale, the counterpart of the repository's ``tools/chaos_bench.py``.

Runs the standard chaos scenarios (``simulation/chaos.py``) on two tiers —
a quick fully-connected core-4 and a tiered/org ``hierarchical_quorum``
network of 50 validators — every node on the GPU with its device tiers
unless ``--device cpu`` (the host tiers, for tests) is given, and prints
one JSON line a scenario:

- close latency over the whole hostile run (network-wide externalize
  spread in virtual ms, wall ms per round, virtual cadence p50/p99),
- time-to-heal: virtual seconds from the last fault clearing until the
  LAST honest survivor externalized the convergence target,
- fault counters (drops/damage/duplicates/cuts/reconnects,
  equivocations emitted, stale envelopes replayed and discarded),
- fork check: header-chain AND bucket-hash agreement over every pair of
  honest survivors (the run aborts on the first divergence),
- the determinism contract: every scenario re-runs under the SAME chaos
  seed and must reproduce its fingerprint (one hash over every honest
  node's (seq, header-hash) externalize sequence) byte-for-byte.

With ``--out`` the whole document is written there as well.  The
network-observatory mode of the repository's tool is not here.

Usage:
    python -m stellar_core_tpu_torch.tools.chaos_bench --tier core4
    python -m stellar_core_tpu_torch.tools.chaos_bench \\
        --tier tiered50 --scenario partition_heal
    ... [--seed N] [--no-rerun] [--out PATH] [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import time

from ..simulation.chaos import STANDARD_SCENARIOS, run_standard_scenario
from ..simulation.simulation import core, hierarchical_quorum
from . import add_device_arg, no_gpu, node_kw

PROG = "python -m stellar_core_tpu_torch.tools.chaos_bench"

TIERS = {
    # label -> (factory(persist_dir, **node keywords), n_nodes, scenario
    # duration s).  core4 runs PIPELINED_CLOSE on, so every scenario also
    # exercises the close pipeline's overlap contract; tiered50 stays
    # pipeline-off (50 tail workers in one process).  Slow-close traces
    # go to the run's own directory.
    "core4": (lambda d, **kw: core(4, persist_dir=d, MANUAL_CLOSE=False,
                                   PIPELINED_CLOSE=True, TRACE_DIR=d, **kw),
              4, 18.0),
    "tiered50": (lambda d, **kw: hierarchical_quorum(
        10, 5, persist_dir=d, MANUAL_CLOSE=False, TRACE_DIR=d, **kw),
        50, 12.0),
}


def _dump_rerun_mismatch(tier: str, scenario: str, seed: int,
                         rep: dict, rep2: dict,
                         forensics_dir: str) -> str:
    """The rerun-mismatch oracle's forensic artifact: both runs'
    per-node externalize maps plus the first (node, seq) whose hash
    differed between the runs."""
    first = None
    a, b = rep["per_node_externalized"], rep2["per_node_externalized"]
    for node in sorted(set(a) | set(b)):
        for s in sorted(set(a.get(node, {})) | set(b.get(node, {})),
                        key=int):
            ha, hb = a.get(node, {}).get(s), b.get(node, {}).get(s)
            if ha != hb and first is None:
                first = {"node": node, "slot": int(s),
                         "run1": ha, "run2": hb}
    doc = {"forensics_schema": 1,
           "scenario": f"rerun_{tier}_{scenario}",
           "seed": seed,
           "reason": "same-seed rerun fingerprint mismatch",
           "first_divergence": first,
           "run1": {"fingerprint": rep["fingerprint"],
                    "per_node_externalized": a},
           "run2": {"fingerprint": rep2["fingerprint"],
                    "per_node_externalized": b}}
    os.makedirs(forensics_dir, exist_ok=True)
    path = os.path.join(
        forensics_dir,
        f"FORENSICS_rerun_{tier}_{scenario}_seed{seed}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def run_one(tier: str, scenario: str, seed: int, rerun: bool,
            forensics_dir: str, **node) -> dict:
    """One scenario of ``tier`` with the node keywords ``node`` (device
    and backends), and its same-seed rerun; the report without its event
    script and externalize maps."""
    factory, n, duration = TIERS[tier]
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as d:
        rep = run_standard_scenario(
            lambda: factory(d, **node), scenario, seed=seed, n_nodes=n,
            duration=duration, forensics_dir=forensics_dir)
    rep["bench_wall_s"] = round(time.monotonic() - t0, 1)
    rep["tier"] = tier
    if rerun:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as d:
            rep2 = run_standard_scenario(
                lambda: factory(d, **node), scenario, seed=seed,
                n_nodes=n, duration=duration, forensics_dir=forensics_dir)
        rep["rerun_wall_s"] = round(time.monotonic() - t0, 1)
        if rep2["fingerprint"] != rep["fingerprint"]:
            path = _dump_rerun_mismatch(tier, scenario, seed, rep, rep2,
                                        forensics_dir)
            raise AssertionError(
                f"[{tier}/{scenario}] chaos seed {seed} NOT "
                f"deterministic: {rep['fingerprint']} vs "
                f"{rep2['fingerprint']}\n[forensics] {path}")
        rep["rerun_identical"] = True
    del rep["events"]
    del rep["per_node_externalized"]
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--tier", choices=sorted(TIERS), action="append",
                    help="run only this tier (repeatable; default all)")
    ap.add_argument("--scenario", choices=STANDARD_SCENARIOS,
                    action="append",
                    help="run only this scenario (repeatable; default all)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--no-rerun", action="store_true",
                    help="skip the same-seed determinism rerun")
    ap.add_argument("--out", default=None,
                    help="also write the whole document to this file")
    ap.add_argument("--forensics-dir", default=None,
                    help="where oracle failures dump FORENSICS_*.json "
                         "(default: chaos-forensics-<pid> in the temporary "
                         "directory, made on the first failure)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.device is None and no_gpu(PROG):
        return 2
    node = node_kw(args.device)
    forensics_dir = args.forensics_dir or os.path.join(
        tempfile.gettempdir(), f"chaos-forensics-{os.getpid()}")

    tiers = args.tier or sorted(TIERS)
    scenarios = args.scenario or list(STANDARD_SCENARIOS)
    results = []
    for tier in tiers:
        for scenario in scenarios:
            rep = run_one(tier, scenario, args.seed, not args.no_rerun,
                          forensics_dir, **node)
            results.append(rep)
            print(json.dumps({"bench": "chaos", **node, **rep},
                             sort_keys=True), flush=True)

    doc = {
        "bench": "chaos scenario suite",
        "seed": args.seed,
        "node": node,
        "tiers": {t: {"nodes": TIERS[t][1], "duration_s": TIERS[t][2]}
                  for t in tiers},
        "scenarios": results,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps({"bench": "chaos", "scenarios": len(results),
                      "fork_check": sorted({r["fork_check"]
                                            for r in results}),
                      "rerun_identical": all(r.get("rerun_identical")
                                             for r in results)
                      if not args.no_rerun else None, **node}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
