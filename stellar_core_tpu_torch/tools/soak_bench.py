"""Sustained-load soak bench on the port, the counterpart of the
repository's ``tools/soak_bench.py``: timer-driven rate-mode load against
ONE disk-backed standalone node on a REAL-TIME clock, measured by the
tx-lifecycle tracker (admission -> durable-commit latency percentiles per
stage) and the vitals sampler (RSS/fd/thread/queue/GC drift with
least-squares slopes and the SLO watchdog).  The soak runs once a
backend: a ``cuda`` node (each close's signature batch through the
verify kernel, tallies on the card) and a ``cpu`` node on the same host,
the two soaks back to back, then each telemetry A/B and parity pass, the
backends' order alternating phase by phase.

What a passing soak shows:

- the node SUSTAINS the offered tx/s: admitted ~= submitted, applied tx/s
  tracks the rate, the queue neither ages out nor bans;
- the latency percentiles per stage (p50/p99);
- nothing drifts: RSS and fd slopes, GC pauses, SLO watchdog breaches;
- the telemetry costs little: the disabled hook sites' cost against the
  close p50, and an enabled A/B; ledger/bucket hashes AND meta bytes are
  bit-identical telemetry on vs off (``_workloads.
  run_telemetry_workload``), on each backend.

The node's database, buckets, vitals file and slow-close traces live in a
temporary directory.  Prints one JSON line a backend and the result
last; writes the result to a file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.soak_bench [--smoke]
           [--rate TX_S] [--duration S] [--accounts N]
           [--ledger-interval S] [--backend cuda|cpu] [--out PATH]
           [--device cpu]
"""
import argparse
import os
import statistics
import sys

from . import (BACKENDS, add_backend_arg, arm, backends, card, emit,
               kernel_launches, no_gpu, standalone_app, turns, work_dir,
               write_out)

PROG = "python -m stellar_core_tpu_torch.tools.soak_bench"


def _note(msg):
    print(f"[soak-bench] {msg}", file=sys.stderr, flush=True)


def _p(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)


def _mk_soak_app(backend: str, node_dir: str, ledger_interval: float,
                 tx_set_size: int):
    from ..main.application import Application
    from ..main.config import Config
    from ..utils.clock import ClockMode, VirtualClock

    os.makedirs(os.path.join(node_dir, "buckets"), exist_ok=True)
    kw = dict(BACKENDS[backend])
    device = kw.pop("device")
    cfg = Config(
        RUN_STANDALONE=True,
        MANUAL_CLOSE=False,               # timer-driven closes: the soak
        EXP_LEDGER_TIMESPAN_SECONDS=ledger_interval,
        ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING=True,  # loadgen modes
        DATABASE=os.path.join(node_dir, "node.db"),
        BUCKET_DIR_PATH_REAL=os.path.join(node_dir, "buckets"),
        TESTING_UPGRADE_MAX_TX_SET_SIZE=tx_set_size,
        DEFERRED_GC=True,
        PIPELINED_CLOSE=True,             # the production close shape
        PARALLEL_APPLY_WORKERS=2,
        SLOW_CLOSE_THRESHOLD_SECONDS=0.0,
        TRACE_DIR=os.path.join(node_dir, "traces"),
        VITALS_ENABLED=True,
        VITALS_PERIOD_SECONDS=1.0,
        VITALS_JSONL=os.path.join(node_dir, "vitals.jsonl"),
        UNSAFE_QUORUM=True,
        **kw,
    )
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg, device=device)
    app.start()
    return app


def _seed(app, lg, accounts: int, slice_txs: int) -> None:
    """Bulk-seed the pool, then fold every slice into the bucket tier
    through real closes so the soak reads production-shaped state, not a
    warm sql-ahead overlay."""
    lg.create_accounts(accounts)
    for lo in range(0, accounts, slice_txs):
        accts = lg.accounts[lo:lo + slice_txs]
        envs = lg.generate_payments(len(accts), accounts=accts)
        admitted = sum(1 for env in envs
                       if app.herder.recv_transaction(env) == 0)
        assert admitted == len(accts), "seeding fold under-admitted"
        # immediate close instead of waiting out the cadence timer
        # (trigger re-arms it, so cancel the pending one first)
        app.herder.trigger_timer.cancel()
        app.herder.trigger_next_ledger()


def soak_run(backend: str, rate: float, duration: float, accounts: int,
             ledger_interval: float) -> dict:
    from ..simulation.load_generator import LoadGenerator

    tx_set_size = max(200, int(rate * ledger_interval * 4))
    with work_dir("soak-bench") as node_dir, arm(backend) as row:
        app = _mk_soak_app(backend, node_dir, ledger_interval, tx_set_size)
        lm = app.ledger_manager
        lg = LoadGenerator(app)
        # seeding stays out of the latency rollups
        app.txtracer.enabled = False
        _seed(app, lg, accounts, min(accounts, tx_set_size))
        lm.pipeline.drain()
        seed_lcl = lm.last_closed_seq()
        seeded_rows = app.database.execute(
            "SELECT COUNT(*) FROM txhistory").fetchone()[0]
        app.txtracer.enabled = True

        close_totals = []
        verify_ms = []

        def on_externalized(seq, sv):
            phases = lm.last_close_phases
            close_totals.append(phases.get("total"))
            verify_ms.append(phases.get("verify"))

        app.herder.on_externalized.append(on_externalized)
        _note(f"measuring {backend}: {rate} tx/s for {duration}s "
              f"({ledger_interval}s ledgers, {accounts} accounts, "
              f"lcl {seed_lcl})")
        clock = app.clock
        launches_seeded = kernel_launches()
        lg.start_rate_run("pay", rate=rate, duration=duration)
        deadline = clock.now() + duration + 2 * ledger_interval
        while clock.now() < deadline:
            app.crank(block=True)
        lg.stop_rate_run()
        lm.pipeline.drain()

        rate_status = lg.rate_status()
        applied = app.database.execute(
            "SELECT COUNT(*) FROM txhistory").fetchone()[0] - seeded_rows
        ledgers = lm.last_closed_seq() - seed_lcl
        tx_report = app.txtracer.report(last=4)
        vit_report = app.vitals.report()
        queue_left = app.herder.tx_queue.size()
        app.graceful_stop()
        measured_launches = kernel_launches() - launches_seeded

    breaches = vit_report["slo"]["breaches"]
    totals = [t for t in close_totals if isinstance(t, (int, float))]
    verifies = [t for t in verify_ms if isinstance(t, (int, float))]
    row.update({
        "config": {"rate_tx_s": rate, "duration_s": duration,
                   "accounts": accounts,
                   "ledger_interval_s": ledger_interval,
                   "pipelined_close": True, "workers": 2},
        "sustained": {
            "submitted": rate_status["submitted"],
            "admit_status_counts": rate_status["status_counts"],
            "submitted_tx_s": round(
                rate_status["submitted"] / duration, 2),
            "applied_txs": applied,
            "applied_tx_s": round(applied / duration, 2),
            "ledgers_closed": ledgers,
            "queue_left": queue_left,
        },
        "close_ms": {"p50": _p(totals, 0.5), "p99": _p(totals, 0.99),
                     "samples": len(totals)},
        "verify_phase_ms": {"p50": _p(verifies, 0.5),
                            "p99": _p(verifies, 0.99)},
        "measured_kernel_launches": measured_launches,
        "tx_latency": tx_report["latency"],
        "tx_tracker": {k: tx_report[k] for k in
                       ("seen", "tracked", "completed", "stride",
                        "decimations")},
        "vitals": {
            "samples": vit_report["samples"],
            "slopes_per_s": vit_report["slopes_per_s"],
            "slopes_tail_per_s": vit_report["slopes_tail_per_s"],
            "rss_slope_mb_s": round(
                vit_report["slopes_per_s"]["rss_bytes"] / 1e6, 4),
            "rss_slope_tail_mb_s": round(
                vit_report["slopes_tail_per_s"]["rss_bytes"] / 1e6, 4),
            "fd_slope_per_s": vit_report["slopes_per_s"]["open_fds"],
            "latest": vit_report["latest"],
            "gc_pause": vit_report["gc_pause"],
        },
        "slo": {"breaches": breaches,
                "watchdog_green": not any(breaches.values())},
    })
    _note(f"{backend}: sustained {row['sustained']['applied_tx_s']} tx/s "
          f"applied over {ledgers} ledgers; close p50 "
          f"{row['close_ms']['p50']}ms; rss slope "
          f"{row['vitals']['rss_slope_mb_s']} MB/s; breaches {breaches}")
    return row


def disabled_cost(backend: str, closes: int = 10, txs: int = 200) -> dict:
    """Two cost numbers for the telemetry subsystems on a ``backend``
    node: ``disabled_pct``, the per-close cost of the DISABLED hook sites
    (one attribute check per admission and per stage-stamp call)
    microbenchmarked and scaled against the close p50; and
    ``enabled_overhead_pct``, a same-session alternating close-phase A/B
    with the tracker stamping + one vitals sample per close vs both off."""
    from time import perf_counter

    from ..simulation.load_generator import LoadGenerator

    with arm(backend) as row:
        app = standalone_app(backend,
                             TESTING_UPGRADE_MAX_TX_SET_SIZE=max(200, txs))
        lm = app.ledger_manager
        lg = LoadGenerator(app)
        lg.create_accounts(txs)
        app.herder.manual_close()
        arms = {"off": [], "on": []}
        for i in range(2 * closes):
            which = "on" if i % 2 else "off"
            app.txtracer.enabled = which == "on"
            envs = lg.generate_payments(txs)
            admitted = sum(1 for env in envs
                           if app.herder.recv_transaction(env) == 0)
            assert admitted == txs
            if which == "on":
                app.vitals.sample_once()
            app.herder.manual_close()
            arms[which].append(lm.last_close_phases["total"])

        # what every close pays when the tracker is OFF: txs admissions
        # + the stage-stamp calls
        app.txtracer.enabled = False

        class _F:
            def full_hash(self):
                return b"\x00" * 32

        frames = [_F() for _ in range(txs)]
        reps = 200
        t0 = perf_counter()
        for _ in range(reps):
            for _f in frames:
                app.txtracer.on_admit(b"\x00" * 32)
            for stage in ("txset", "nominate", "externalize", "apply",
                          "commit"):
                app.txtracer.stamp_frames(frames, stage)
        disabled_ms_per_close = (perf_counter() - t0) / reps * 1000.0
        app.graceful_stop()

    off_p50 = round(statistics.median(arms["off"]), 3)
    on_p50 = round(statistics.median(arms["on"]), 3)
    row.update({
        "closes_per_arm": closes, "close_txs": txs,
        "off_close_p50_ms": off_p50, "on_close_p50_ms": on_p50,
        "disabled_us_per_close": round(disabled_ms_per_close * 1000.0, 2),
        "disabled_pct": (round(disabled_ms_per_close / off_p50 * 100.0, 4)
                         if off_p50 else None),
        "enabled_overhead_pct": (
            round((on_p50 - off_p50) / off_p50 * 100.0, 2)
            if off_p50 else None)})
    return row


def parity_pass(backend: str) -> dict:
    """Telemetry on vs off over the deterministic mixed workload on
    ``backend`` nodes: every per-close (ledger hash, bucket hash, meta
    bytes) must match — the stamps are observational."""
    from ._workloads import identical, run_telemetry_workload

    with arm(backend) as row:
        on = run_telemetry_workload(True, pipelined=True,
                                    **BACKENDS[backend])
        off = run_telemetry_workload(False, pipelined=True,
                                     **BACKENDS[backend])
    ok = identical(on, off)
    row.update({"closes": len(on), "hashes_identical": ok,
                "meta_bytes_identical": ok,
                "last_ledger_hash": on[-1][0].hex()})
    _note(f"parity {backend}: {len(on)} closes, identical={ok}")
    if not ok:
        raise SystemExit("telemetry on/off parity FAILED")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--duration", type=float, default=200.0)
    ap.add_argument("--accounts", type=int, default=3000)
    ap.add_argument("--ledger-interval", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="~30 s a backend: shorter run, lower rate")
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    if args.smoke:
        args.rate, args.duration, args.accounts = 40.0, 30.0, 400

    # each phase on every backend back to back, the order alternating
    # phase by phase (``turns``)
    runs = {b: soak_run(b, args.rate, args.duration, args.accounts,
                        args.ledger_interval) for b in turns(arms, 0)}
    for b in turns(arms, 1):
        runs[b]["disabled_cost"] = disabled_cost(b)
    for b in turns(arms, 2):
        runs[b]["parity"] = parity_pass(b)
    rows = [runs[b] for b in arms]
    for row in rows:
        emit(row)
    doc = {
        "bench": "sustained-load soak",
        "card": card(),
        "smoke": bool(args.smoke),
        "backends": arms,
        "runs": rows,
        "notes": (
            "one disk-backed standalone node a backend, REAL_TIME clock, "
            "timer-driven closes, loadgen rate mode; one soak a backend, "
            "the backends' soaks back to back; latency = "
            "tx-lifecycle tracker stage histograms (ms); vitals slopes = "
            "least-squares over the sampler ring; disabled_cost = "
            "alternating same-session close-phase A/B; parity = per-close "
            "header/bucket hashes AND meta bytes, telemetry on vs off"),
    }
    write_out(args.out, doc)
    emit({"bench": doc["bench"], "card": doc["card"], "backends": arms,
          "runs": [{k: r[k] for k in (
              "backend", "sustained", "close_ms", "verify_phase_ms",
              "crypto.verify.kernel-launches", "measured_kernel_launches",
              "slo")} | {"parity_identical": r["parity"]["hashes_identical"]}
              for r in rows]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
