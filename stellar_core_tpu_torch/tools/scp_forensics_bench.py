"""Consensus-forensics bench on the port, the counterpart of the
repository's ``tools/scp_forensics_bench.py``: recorder overhead and the
induced-fork probe, each once a backend (a ``cuda`` node or network: the
verify kernel and the tallies on the card; a ``cpu`` one on the same
host).

1. **Recorder overhead**: 1,000-tx closes on a standalone node a backend,
   alternating the SCP timeline recorder ON and OFF within one session in
   A/B/B/A order (which cancels linear drift out of the medians), the
   backends' nodes closing in turns; the gate is overhead < 2% of close
   p50.
2. **Induced-fork forensic validation**: a deliberately-unsafe core-4
   network (threshold 2, no quorum intersection) with one full Byzantine
   bridge MUST fork; the ``FORENSICS_*.json`` dump must attribute the
   first divergence to the Byzantine node via equivocation evidence, and
   a same-seed rerun must reproduce the dump byte for byte (its sha256 is
   in the result).

Prints one JSON line a measurement and backend and the result last;
writes the result to a file only with ``--out``.  Exit status 1 when a
gate fails.

Usage: python -m stellar_core_tpu_torch.tools.scp_forensics_bench
           [--smoke] [--closes N] [--txs N] [--fork-seed S]
           [--fork-duration S] [--backend cuda|cpu] [--out PATH]
           [--device cpu]
"""
import argparse
import hashlib
import os
import statistics
import sys
import time

from . import (BACKENDS, add_backend_arg, arm, arm_row, backends, card,
               counting, emit, idle_note, no_gpu, standalone_app, turns,
               work_dir, write_out)

PROG = "python -m stellar_core_tpu_torch.tools.scp_forensics_bench"


def _note(msg):
    print(f"[scp-forensics] {msg}", file=sys.stderr, flush=True)


def bench_overhead(arms, n_closes: int, close_txs: int) -> list:
    """Same-session A/B/B/A, timeline recording on vs off, on one node a
    backend.  The nodes close in turns (``turns``), so a drift of the host
    falls on every backend alike; one row a backend."""
    from ..simulation.load_generator import LoadGenerator

    rows, nodes = {}, {}
    for backend in arms:
        rows[backend] = arm_row(backend)
        with counting(rows[backend]):
            app = standalone_app(
                backend, UPGRADE_DESIRED_MAX_TX_SET_SIZE=max(100, close_txs),
                SCP_TIMELINE_ENABLED=True)
            app.herder.manual_close()  # applies the tx-set-size upgrade
            lg = LoadGenerator(app)
            lg.create_accounts(max(close_txs, 100))
            app.herder.manual_close()
        nodes[backend] = (app, lg, {"off": [], "on": []})
    pattern = ("off", "on", "on", "off")
    for i in range(2 * n_closes):
        which = pattern[i % 4]
        for backend in turns(arms, i):
            app, lg, times = nodes[backend]
            with counting(rows[backend]):
                app.herder.scp.timeline.enabled = (which == "on")
                envs = lg.generate_payments(close_txs)
                admitted = sum(1 for env in envs
                               if app.herder.recv_transaction(env) == 0)
                assert admitted == close_txs, f"only {admitted} admitted"
                t0 = time.perf_counter()
                app.herder.manual_close()
                times[which].append((time.perf_counter() - t0) * 1000.0)
    out = []
    for backend in arms:
        app, _lg, times = nodes[backend]
        events = sum(len(b.events)
                     for b in app.herder.scp.timeline._slots.values())
        app.graceful_stop()
        p50_off = round(statistics.median(times["off"]), 2)
        p50_on = round(statistics.median(times["on"]), 2)
        overhead = round((p50_on - p50_off) / p50_off * 100.0, 3) \
            if p50_off else 0.0
        row = rows[backend]
        idle_note(row)
        row.update({
            "n_closes_per_arm": n_closes,
            "close_txs": close_txs,
            "close_p50_ms": {"recorder_off": p50_off,
                             "recorder_on": p50_on},
            "overhead_pct_p50": overhead,
            "gate_overhead_lt_2pct": overhead < 2.0,
            "events_recorded": events,
            "closes_total": 2 * n_closes,
        })
        out.append(row)
    return out


def fork_probe(backend: str, seed: int, duration: float) -> dict:
    """The induced fork twice (same seed) on a ``backend`` network:
    attribution, byte determinism and the dump's sha256."""
    from ..simulation.chaos import run_induced_fork
    from ..simulation.simulation import core

    with arm(backend) as row:
        digests, reports, paths, seconds = [], [], [], []
        for _run in range(2):
            with work_dir("scp-forensics") as d:
                t0 = time.perf_counter()
                rep, path = run_induced_fork(
                    lambda: core(4, threshold=2, persist_dir=d,
                                 MANUAL_CLOSE=False, TRACE_DIR=d,
                                 **BACKENDS[backend]),
                    seed=seed, duration=duration, forensics_dir=d)
                seconds.append(round(time.perf_counter() - t0, 2))
                with open(path, "rb") as f:
                    digests.append(hashlib.sha256(f.read()).hexdigest())
                reports.append(rep)
                paths.append(os.path.basename(path))
    rep = reports[0]
    fd = rep["first_divergence"]
    byz = rep["nodes"]["byzantine"]
    row.update({
        "seed": seed,
        "duration": duration,
        "dump": paths[0],
        "dump_sha256": digests[0],
        "byzantine": byz,
        "first_divergence": {k: fd[k] for k in ("via", "slot", "node")},
        "attributed_to_byzantine": fd["via"] == "equivocation"
        and fd["node"] in byz,
        "equivocation_groups": len(rep["equivocations"]),
        "divergence_slot": rep["divergence"]["slot"],
        "rerun_dump_identical": digests[0] == digests[1],
        "seconds": seconds,
    })
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast gate: fewer/smaller closes")
    ap.add_argument("--closes", type=int, default=None)
    ap.add_argument("--txs", type=int, default=None)
    ap.add_argument("--fork-seed", type=int, default=14)
    ap.add_argument("--fork-duration", type=float, default=40.0)
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    n_closes = args.closes or (3 if args.smoke else 8)
    close_txs = args.txs or (200 if args.smoke else 1000)

    _note(f"overhead A/B {arms} in turns: {n_closes} closes/arm x "
          f"{close_txs} txs")
    overhead = bench_overhead(arms, n_closes, close_txs)
    for row in overhead:
        emit({"measurement": "overhead", **row})
    probes = []
    for backend in turns(arms, 1):
        _note(f"induced-fork probe {backend} (seed {args.fork_seed}) x2")
        probes.append(fork_probe(backend, args.fork_seed,
                                 args.fork_duration))
        emit({"measurement": "fork_probe", **probes[-1]})
    ok = all(o["gate_overhead_lt_2pct"] for o in overhead) and all(
        p["attributed_to_byzantine"] and p["rerun_dump_identical"]
        for p in probes)
    doc = {
        "bench": "SCP forensics: recorder overhead + fork attribution",
        "mode": "smoke" if args.smoke else "full",
        "card": card(),
        "backends": arms,
        "overhead": overhead,
        "fork_probe": probes,
        "dump_sha256_equal_across_backends": len(
            {p["dump_sha256"] for p in probes}) == 1,
        "ok": ok,
    }
    write_out(args.out, doc)
    emit(doc)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
