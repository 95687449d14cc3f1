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

With ``--out`` the whole document is written there as well.

``--netobs`` runs the network-observatory bench instead: per tier a
network under chaos and rate-mode load with the observatory and the crank
profiler armed, flood tracing on and then off, once a backend (a ``cuda``
network: every node's per-crank envelope batch through the verify kernel,
tallies on the card; a ``cpu`` network: the host tiers), the on and off
runs in turns.  Each arm's row carries the card, the verify kernel's
launches, the overlay's envelope batches, triples and padded rows, and
the crank wall split by subsystem; then the five gates of each backend
(hop records, coverage percentiles, the disabled stamp cost < 2% of the
close p50, on/off hashes and meta equal, >= 90% of the crank wall
attributed) are asserted, and the backends' digests must be equal.

Usage:
    python -m stellar_core_tpu_torch.tools.chaos_bench --tier core4
    python -m stellar_core_tpu_torch.tools.chaos_bench \\
        --tier tiered50 --scenario partition_heal
    python -m stellar_core_tpu_torch.tools.chaos_bench --netobs \\
        [--tier core4|tiered50] [--backend cuda|cpu]
    ... [--seed N] [--no-rerun] [--out PATH] [--device cpu]
"""
import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

from ..simulation.chaos import STANDARD_SCENARIOS, run_standard_scenario
from ..simulation.simulation import core, hierarchical_quorum
from . import (BACKENDS, add_backend_arg, arm_row, backends, counting, emit,
               idle_note, no_gpu, node_kw, turns, write_out)

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


# ---------------------------------------------------------------------------
# network-observatory bench (--netobs): propagation percentiles + per-link
# redundancy + crank wall attribution under chaos + loadgen rate mode,
# with the tracing on/off overhead + inertness gates, once a backend
# ---------------------------------------------------------------------------

NETOBS_TIERS = {
    # label -> (factory(persist_dir, **config_kw), n_nodes,
    #           loadgen tx/s, load window virtual s)
    "core4": (lambda d, **kw: core(4, persist_dir=d, MANUAL_CLOSE=False,
                                   PIPELINED_CLOSE=True, TRACE_DIR=d, **kw),
              4, 20.0, 6.0),
    "tiered50": (lambda d, **kw: hierarchical_quorum(
        10, 5, persist_dir=d, MANUAL_CLOSE=False, TRACE_DIR=d, **kw),
        50, 5.0, 4.0),
}


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if s else None


def _run_digests(sim) -> dict:
    """Deterministic digests of everything consensus produced: one hash
    over every node's (seq, header hash, bucket hash) chain and one over
    every node's LedgerCloseMeta stream — the on/off inertness oracle."""
    import hashlib

    from ..xdr import types as T

    hh = hashlib.sha256()
    hm = hashlib.sha256()
    for nid in sorted(sim.nodes):
        chain = sim.header_chain(nid)
        hh.update(nid)
        for seq in sorted(chain):
            header_hash, bucket_hash = chain[seq]
            hh.update(seq.to_bytes(4, "big"))
            hh.update(header_hash)
            hh.update(bucket_hash)
        hm.update(nid)
        for meta in sim.nodes[nid]._meta_stream:
            hm.update(T.LedgerCloseMeta.encode(meta))
    return {"hashes": hh.hexdigest(), "meta": hm.hexdigest()}


@contextlib.contextmanager
def overlay_counting(row: dict):
    """Adds to ``row`` what every node's per-crank SCP envelope batch did
    inside the block (``OverlayManager._verify_triples``): the batches,
    their triples, the batches that launched the verify kernel, the
    padded rows those launches verified, and the host seconds spent in
    the batches (packing, copies, launch and readback, or host
    verifies)."""
    from ..ops import ed25519_cuda
    from ..overlay.manager import OverlayManager

    for k in ("overlay_batches", "overlay_triples",
              "overlay_launched_batches", "overlay_padded_rows"):
        row.setdefault(k, 0)
    row.setdefault("overlay_verify_s", 0.0)
    real_triples, real_verify = (OverlayManager._verify_triples,
                                 ed25519_cuda.verify_batch)
    rows = []

    def verify_batch(pk, *args):
        rows.append(int(pk.shape[0]))
        return real_verify(pk, *args)

    def verify_triples(om, triples):
        del rows[:]
        launches0 = ed25519_cuda.launches
        t0 = time.perf_counter()
        out = real_triples(om, triples)
        row["overlay_verify_s"] += time.perf_counter() - t0
        row["overlay_batches"] += 1
        row["overlay_triples"] += len(triples)
        if ed25519_cuda.launches != launches0:
            row["overlay_launched_batches"] += 1
            row["overlay_padded_rows"] += sum(rows)
        return out

    OverlayManager._verify_triples = verify_triples
    ed25519_cuda.verify_batch = verify_batch
    try:
        yield row
    finally:
        OverlayManager._verify_triples = real_triples
        ed25519_cuda.verify_batch = real_verify


@contextlib.contextmanager
def tally_counting(row: dict):
    """Adds to ``row`` the tensor tallies inside the block
    (``TallyEngine.device_accept`` / ``device_ratify``: the vote rows'
    copy, the quorum ops and the verdict's readback on the engine's
    device) and the host seconds they took.  A host-tier network makes
    none."""
    from ..scp.tally import TallyEngine

    row.setdefault("tally_calls", 0)
    row.setdefault("tally_s", 0.0)
    reals = {name: getattr(TallyEngine, name)
             for name in ("device_accept", "device_ratify")}

    def timed(real):
        def call(engine, *args):
            t0 = time.perf_counter()
            try:
                return real(engine, *args)
            finally:
                row["tally_s"] += time.perf_counter() - t0
                row["tally_calls"] += 1
        return call

    for name, real in reals.items():
        setattr(TallyEngine, name, timed(real))
    try:
        yield row
    finally:
        for name, real in reals.items():
            setattr(TallyEngine, name, real)


def netobs_run(tier: str, seed: int, trace_on: bool, **node) -> dict:
    """One instrumented run with the node keywords ``node`` (device and
    backends): core-N under loadgen rate mode with a partition/heal fault
    window and 50 ms of injected minority-link latency (so propagation
    percentiles measure something), the observatory + crank profiler
    armed throughout."""
    from ..ledger.ledger_txn import LedgerTxn
    from ..simulation.chaos import ChaosEngine
    from ..simulation.load_generator import LoadGenerator

    factory, n, rate, load_s = NETOBS_TIERS[tier]
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="netobs-") as d:
        sim = factory(d, FLOOD_TRACE_ENABLED=trace_on, **node)
        sim.attach_observatory()
        sim.start_all_nodes()
        while sim.crank():
            pass  # handshakes settle at t=0
        sim.enable_crank_profiler()
        ids = sorted(sim.nodes)
        app0 = sim.nodes[ids[0]]
        assert sim.crank_until(lambda: sim.have_all_externalized(2), 120)

        # seed loadgen accounts THROUGH consensus — a direct ledger
        # write on one node of a live network would be a fork
        lg = LoadGenerator(app0)
        for env in lg.create_account_envelopes(8):
            assert app0.herder.recv_transaction(env) == 0

        def _seeded():
            with LedgerTxn(app0.ledger_manager.root) as ltx:
                e = ltx.load_account(lg.accounts[-1].public_key().raw)
                ltx.rollback()
            return e is not None

        assert sim.crank_until(_seeded, 120), "account seeding stalled"

        chaos = ChaosEngine(sim, seed=seed)
        chaos.start_maintenance()  # cut links need periodic re-dials
        lg.start_rate_run("pay", rate=rate, duration=load_s)
        minority = ids[: max(1, (n - 1) // 3)]
        majority = [i for i in ids if i not in minority]
        # latency on the minority's links: nonzero hop deltas for the
        # coverage percentiles even while the partition is open
        chaos.lag(minority[0], 0.05)
        sim.crank_for(1.5)
        chaos.partition([minority, majority])
        sim.crank_for(load_s / 2.0)
        chaos.heal()
        chaos.clear_links()
        chaos.maintain_links_once()
        sim.crank_for(load_s / 2.0)
        lg.stop_rate_run()
        target = max(a.ledger_manager.last_closed_seq()
                     for a in sim.alive_nodes().values()) + 2
        assert sim.crank_until(
            lambda: sim.have_all_externalized(target), 240), \
            "post-heal convergence stalled"
        # every node's last close tail lands before the digests are read:
        # a pipelined close commits and emits its ledger's meta on a tail
        # worker, which the virtual clock does not wait for
        for app in sim.nodes.values():
            app.ledger_manager.pipeline.drain()
        sim.assert_no_forks()

        obs = sim.observatory.summary()
        n_items = sum(a.floodtracer.stats()["live"]
                      + a.floodtracer.stats()["retired"]
                      for a in sim.nodes.values())
        crank = sim.crank_report()
        close_p50 = _median(
            [a.metrics.timer("ledger.ledger.close").summary()["p50"]
             for a in sim.nodes.values()])
        # flood stamp volume, for the disabled-cost scaling: inbound
        # flood copies (counted tracing on or off) and closes per node
        flood_events = sum(
            a.metrics.counter("overlay.flood.unique").count
            + a.metrics.counter("overlay.flood.duplicate").count
            for a in sim.nodes.values())
        closes = sum(
            a.metrics.timer("ledger.ledger.close").summary()["count"]
            for a in sim.nodes.values())
        digests = _run_digests(sim)
        rate_rep = lg.rate_status()
        chaos.stop()
        for app in sim.nodes.values():
            app.stop_node()
    return {
        "tier": tier,
        "trace_enabled": trace_on,
        "n_nodes": n,
        "hop_records_total": n_items,
        "observatory": obs,
        "crank_attribution": crank,
        "close_p50_wall_s": round(close_p50, 6) if close_p50 else None,
        "flood_events_total": flood_events,
        "closes_total": closes,
        "loadgen": {"submitted": rate_rep.get("submitted", 0),
                    "ticks": rate_rep.get("ticks", 0)},
        "digests": digests,
        "bench_wall_s": round(time.monotonic() - t0, 1),
    }


def _disabled_stamp_cost_s() -> float:
    """Per-site cost of a DISABLED tracker stamp.  Every flood site is
    guard-shaped — `ft = app.floodtracer; if ft.enabled: ...` — so the
    disabled path executes two attribute loads and a branch, nothing
    else.  Measure exactly that (loop overhead subtracted, floored at
    10ns so the gate never divides by a measurement artifact), then
    scale by the run's observed flood volume for the <2% gate."""
    from ..utils.floodtrace import FloodPropagationTracker
    from ..utils.metrics import MetricsRegistry

    app = type("_App", (), {})()
    app.floodtracer = FloodPropagationTracker(metrics=MetricsRegistry(),
                                              enabled=False)
    n = 500_000

    def _site_loop(count):
        t0 = time.perf_counter()
        for _ in range(count):
            ft = app.floodtracer
            if ft.enabled:
                ft.note_recv(b"", "", True, "tx", 1)
        return time.perf_counter() - t0

    def _empty_loop(count):
        t0 = time.perf_counter()
        for _ in range(count):
            pass
        return time.perf_counter() - t0

    _site_loop(n // 10)  # warm
    _empty_loop(n // 10)
    site = min(_site_loop(n) for _ in range(3))
    empty = min(_empty_loop(n) for _ in range(3))
    return max((site - empty) / n, 1e-8)


def netobs_gates(on: dict, off: dict, stamp_s: float) -> dict:
    """The five gates of one backend's on/off pair, as the repository's
    tool computes them.  The <2%-of-close-p50 overhead gate is the
    DISABLED cost (the attribute check per flood site, microbenched and
    scaled by the run's flood volume per close); the enabled on/off close
    delta is reported but not gated."""
    p_on, p_off = on["close_p50_wall_s"], off["close_p50_wall_s"]
    enabled_pct = round((p_on - p_off) / p_off * 100.0, 2) \
        if p_on and p_off else None
    # disabled cost: ~2 stamp sites per inbound copy (recv stamp + the
    # broadcast-site enabled checks), per close, vs close p50
    sites_per_close = (2.0 * off["flood_events_total"]
                       / max(1, off["closes_total"]))
    disabled_pct = round(stamp_s * sites_per_close / p_off * 100.0, 4) \
        if p_off else None
    prop = on["observatory"]["propagation"]
    return {
        "hop_records_nonzero": on["hop_records_total"] > 0,
        "coverage_percentiles_present": prop["time_to_90pct"] is not None,
        "disabled_stamp_us": round(stamp_s * 1e6, 3),
        "stamp_sites_per_close": round(sites_per_close, 1),
        "tracing_overhead_pct": disabled_pct,
        "tracing_overhead_ok": disabled_pct is not None
        and disabled_pct < 2.0,
        "enabled_overhead_pct": enabled_pct,
        "inert_hashes_and_meta": on["digests"] == off["digests"],
        "attributed_pct": on["crank_attribution"]["attributed_pct"],
        "attribution_ok":
            on["crank_attribution"]["attributed_pct"] >= 90.0,
    }


def netobs_arm(backend: str, tier: str, seed: int, trace_on: bool) -> dict:
    """One backend's run of ``tier``: the run's report, and its row (the
    arm's card and launches, the overlay's batches, the tensor tallies,
    the crank split)."""
    row = arm_row(backend)
    with counting(row), overlay_counting(row), tally_counting(row):
        rep = netobs_run(tier, seed, trace_on, **BACKENDS[backend])
    idle_note(row)
    crank = rep["crank_attribution"]
    row.update({
        "bench": "netobs", "tier": tier, "trace_enabled": trace_on,
        "buckets_s": crank["buckets_s"], "events": crank["events"],
        "wall_per_virtual_s": crank.get("wall_per_virtual_s"),
        "attributed_pct": crank["attributed_pct"],
        "close_p50_wall_s": rep["close_p50_wall_s"],
        "hop_records_total": rep["hop_records_total"],
        "digests": rep["digests"], "bench_wall_s": rep["bench_wall_s"]})
    rep["arm"] = row
    return rep


def run_netobs(tiers, seed: int, arms, out=None) -> dict:
    """The network-observatory evidence run: per tier and backend, tracing
    ON for the observatory evidence and OFF for the inertness A/B, the
    backends in turns (on: A B, off: B A).  Every arm's row is printed
    before the gates are asserted; the backends' digests must be equal.
    The document is written to ``out`` (when given) once every gate
    held."""
    results = {}
    stamp_s = _disabled_stamp_cost_s()
    if "cuda" in arms:
        import torch

        from ..ops import ed25519_cuda

        # the kernel's build and the device's start-up before the first
        # arm, so that no arm's crank split carries them
        ed25519_cuda.build()
        torch.zeros(1, device="cuda").sum().item()
    for tier in tiers:
        runs = {b: {} for b in arms}
        for i, trace_on in enumerate((True, False)):
            for b in turns(arms, i):
                runs[b][trace_on] = rep = netobs_arm(b, tier, seed,
                                                     trace_on)
                emit(rep["arm"])
        res = results[tier] = {}
        for b in arms:
            on, off = runs[b][True], runs[b][False]
            res[b] = {
                "on": on, "off": {k: off[k] for k in
                                  ("close_p50_wall_s", "digests",
                                   "crank_attribution", "bench_wall_s",
                                   "flood_events_total", "closes_total",
                                   "arm")},
                "gates": netobs_gates(on, off, stamp_s)}
            emit({"bench": "netobs", "tier": tier, "backend": b,
                  "gates": res[b]["gates"],
                  "t90": on["observatory"]["propagation"]["time_to_90pct"],
                  "wall_s": [on["bench_wall_s"], off["bench_wall_s"]]})
        for b in arms:
            g = res[b]["gates"]
            assert g["hop_records_nonzero"], f"{tier}/{b}: no hop records"
            assert g["coverage_percentiles_present"], \
                f"{tier}/{b}: no coverage percentiles"
            assert g["inert_hashes_and_meta"], \
                f"{tier}/{b}: tracing on/off NOT bit-identical"
            assert g["tracing_overhead_ok"], \
                f"{tier}/{b}: disabled cost {g['tracing_overhead_pct']}% " \
                f">= 2%"
            assert g["attribution_ok"], \
                f"{tier}/{b}: only {g['attributed_pct']}% of wall attributed"
        digests = {b: res[b]["on"]["digests"] for b in arms}
        assert len({json.dumps(d, sort_keys=True)
                    for d in digests.values()}) == 1, \
            f"{tier}: the backends' digests differ: {digests}"
    doc = {"bench": "network observatory", "seed": seed, "backends": arms,
           "tiers": results}
    write_out(out, doc)
    return doc


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
    ap.add_argument("--netobs", action="store_true",
                    help="run the network-observatory bench instead: "
                         "propagation percentiles, crank wall "
                         "attribution, on/off overhead + inertness gates "
                         "under chaos + loadgen, once a backend")
    ap.add_argument("--out", default=None,
                    help="also write the whole document to this file")
    ap.add_argument("--forensics-dir", default=None,
                    help="where oracle failures dump FORENSICS_*.json "
                         "(default: chaos-forensics-<pid> in the temporary "
                         "directory, made on the first failure)")
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    if args.netobs:
        doc = run_netobs(args.tier or sorted(NETOBS_TIERS), args.seed, arms,
                         args.out)
        emit({"bench": "netobs", "seed": args.seed, "backends": arms,
              "tiers": {t: {b: r["gates"] for b, r in res.items()}
                        for t, res in doc["tiers"].items()}})
        return 0
    if args.backend:
        ap.error("--backend picks the arms of --netobs")
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
