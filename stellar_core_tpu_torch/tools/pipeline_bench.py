"""Pipelined-close A/B bench on the port, the counterpart of the
repository's ``tools/pipeline_bench.py``: mixed and pay-heavy 1,000-tx
closes through the full node close path on a disk-backed node,
alternating pipeline-on and pipeline-off closes IN THE SAME SESSION so
ledger-state drift (book growth, bucket spills) hits both arms equally.
Every shape runs once a backend: on a ``cuda`` node (the close's
signature batch through the verify kernel, tallies on the card) and on a
``cpu`` node on the same host, back to back, the order alternating shape
by shape (``turns``).

What it measures:

- close-phase p50 with the commit/meta/tx-history/gc tail staged on the
  worker (``tail_ms_reclaimed``: close-thread ms the off arm pays inline;
  ``tail_deferred_ms``: flight-recorder span time ledger N's tail spent
  AFTER N's close root ended, concurrent with the next cycle);
- the footprint prefetch staged at nomination: hit rate, close-thread SQL
  point reads;
- a parity pass: the same deterministic workload (``_workloads.
  run_workload``) pipeline on vs off, every per-close (ledger hash,
  bucket hash, meta bytes) equal, on each backend.

``--lockdep-probe`` instead reports the lockdep witness's acquisitions
and guarded-field checks per pipelined pay close (meaningful under
LOCKDEP=1).

Prints one JSON line a shape and backend and the result last; writes the
result to a file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.pipeline_bench
           [--closes N] [--close-txs N] [--dex-pct P] [--workers N]
           [--accounts N] [--lockdep-probe] [--backend cuda|cpu]
           [--out PATH] [--device cpu]
"""
import argparse
import os
import statistics
import sys
import time

from . import (BACKENDS, add_backend_arg, arm, backends, card, emit,
               no_gpu, standalone_app, turns, work_dir, write_out)

PROG = "python -m stellar_core_tpu_torch.tools.pipeline_bench"


def _note(msg):
    print(f"[pipeline-bench] {msg}", file=sys.stderr, flush=True)


def _pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(q * len(xs)))], 2)


def _p50(xs):
    return round(statistics.median(xs), 2) if xs else None


def _mk_app(backend: str, workers: int, close_txs: int, node_dir: str):
    # production-shaped durability: a real SQLite file + on-disk bucket
    # store — the tail the pipeline defers is this node's durable-commit
    # work, and benching it on :memory: would understate it
    os.makedirs(os.path.join(node_dir, "buckets"), exist_ok=True)
    app = standalone_app(
        backend,
        UPGRADE_DESIRED_MAX_TX_SET_SIZE=max(100, close_txs),
        DEFERRED_GC=True,
        PIPELINED_CLOSE=True,
        PIPELINED_CLOSE_EAGER_DRAIN=False,  # measure the real overlap
        PARALLEL_APPLY_WORKERS=workers,
        NATIVE_APPLY_INLINE=workers < 2,
        DATABASE=os.path.join(node_dir, "node.db"),
        BUCKET_DIR_PATH_REAL=os.path.join(node_dir, "buckets"),
        TRACE_DIR=os.path.join(node_dir, "traces"))
    app.herder.manual_close()  # applies the max-tx-set-size upgrade
    return app


def _tail_overlap_from_ring(app) -> tuple:
    """Flight-recorder proof of the overlap, per ledger N with a
    committed record: (deferred_ms, next_close_overlap_ms) where
    deferred = tail-span time spent AFTER N's close root ended and
    next_close_overlap = the part of that which coincided with ledger
    N+1's close root."""
    recs = {rec.seq: rec for rec in app.tracer.closes()}
    deferred, next_overlap = [], []
    for seq, rec in recs.items():
        root_n = next((sp for sp in rec.spans
                       if sp.name == "ledger.close"), None)
        if root_n is None:
            continue
        tails = [sp for sp in rec.spans
                 if sp.name in ("ledger.close.commit",
                                "ledger.close.meta", "ledger.close.gc")]
        if not tails:
            continue
        deferred.append(round(sum(
            max(0.0, sp.t1 - max(sp.t0, root_n.t1))
            for sp in tails) * 1000.0, 3))
        nxt = recs.get(seq + 1)
        root_next = None if nxt is None else next(
            (sp for sp in nxt.spans if sp.name == "ledger.close"), None)
        if root_next is not None:
            next_overlap.append(round(sum(
                max(0.0, min(sp.t1, root_next.t1)
                    - max(sp.t0, root_next.t0))
                for sp in tails) * 1000.0, 3))
    return deferred, next_overlap


def _seed_and_fold(app, lg, n: int, close_txs: int) -> None:
    """Bulk-seed ``n`` accounts, then run one UNTIMED payment rotation
    over every slice so each account's state is written by a real
    close — folding it off the sql-ahead overlay into the BUCKET tier,
    where the footprint prefetch (and cold reads) can find it."""
    lg.create_accounts(n)
    for lo in range(0, n, close_txs):
        accts = lg.accounts[lo:lo + close_txs]
        envs = lg.generate_payments(len(accts), accounts=accts)
        admitted = sum(1 for env in envs
                       if app.herder.recv_transaction(env) == 0)
        assert admitted == len(accts), "seeding fold under-admitted"
        app.herder.manual_close()
    root = app.ledger_manager.root
    # only never-closed stragglers (the genesis root) may remain
    assert len(root._sql_ahead) < 4, \
        f"{len(root._sql_ahead)} seeded keys still on the sql-ahead " \
        f"overlay — the fold failed"


def lockdep_probe(backend: str, n_closes: int, close_txs: int,
                  workers: int) -> dict:
    """Per-close witness accounting: ``n_closes`` pipelined pay closes on
    one node, the lock acquisitions + guarded-field checks the witness
    performed PER CLOSE (seeding excluded) beside the round-trip close
    p50.  With the witness disabled the counts are zero and the report
    says so."""
    from ..simulation.load_generator import LoadGenerator
    from ..utils import lockdep

    with work_dir("lockdep-probe") as node_dir, arm(backend) as row:
        app = _mk_app(backend, workers, close_txs, node_dir)
        lg = LoadGenerator(app)
        lg.payment_pattern = "pairs"
        n_accounts = 4 * close_txs
        _seed_and_fold(app, lg, n_accounts, close_txs)
        n_slices = max(1, n_accounts // close_txs)
        before = lockdep.stats()
        walls = []
        for i in range(n_closes):
            lo = (i % n_slices) * close_txs
            hi = ((i + 1) % n_slices) * close_txs
            envs = lg.generate_payments(
                close_txs, accounts=lg.accounts[lo:lo + close_txs],
                dest_accounts=lg.accounts[hi:hi + close_txs])
            admitted = sum(1 for env in envs
                           if app.herder.recv_transaction(env) == 0)
            assert admitted == close_txs, f"only {admitted} admitted"
            t0 = time.perf_counter()
            app.herder.manual_close()
            walls.append((time.perf_counter() - t0) * 1000.0)
        app.ledger_manager.pipeline.drain()
        after = lockdep.stats()
        app.graceful_stop()
    row.update({
        "enabled": after["enabled"],
        "closes": n_closes,
        "close_txs": close_txs,
        "close_p50_ms": _p50(walls),
        "acquires_per_close": round(
            (after["acquires"] - before["acquires"]) / n_closes, 1),
        "guard_checks_per_close": round(
            (after["guard_checks"] - before["guard_checks"]) / n_closes,
            1),
        "inversions": after["inversions"],
        "guard_violations": after["guard_violations"],
    })
    return row


def bench_workload(backend: str, shape: str, n_closes: int, close_txs: int,
                   dex_pct: int, workers: int, n_accounts: int) -> dict:
    from ..simulation.load_generator import LoadGenerator

    with work_dir(f"pipeline-bench-{shape}") as node_dir, \
            arm(backend) as row:
        app = _mk_app(backend, workers, close_txs, node_dir)
        lm = app.ledger_manager
        pipeline = lm.pipeline
        lg = LoadGenerator(app)
        lg.payment_pattern = "pairs"
        # an account pool MANY closes wide, seeded through real closes
        # into the bucket tier: each bench close draws a rotating slice
        # whose keys fell out of the root cache since their last touch,
        # so the footprint prefetch has real work
        _seed_and_fold(app, lg, n_accounts, close_txs)
        if shape == "mixed":
            lg.setup_dex(lg.accounts[:close_txs])
        n_slices = max(1, n_accounts // close_txs)
        arms = {"off": [], "on": []}
        phases = {"off": [], "on": []}
        sql_reads = {"off": 0, "on": 0}
        for i in range(2 * n_closes):
            which = "on" if i % 2 else "off"
            if which == "off":
                pipeline.drain()
            pipeline.enabled = (which == "on")
            # sources from slice i, destinations from slice i+1: the
            # staged prefetch has the destinations to load from buckets
            lo = (i % n_slices) * close_txs
            hi = ((i + 1) % n_slices) * close_txs
            accts = lg.accounts[lo:lo + close_txs]
            dests = lg.accounts[hi:hi + close_txs]
            envs = (lg.generate_mixed(close_txs, dex_percent=dex_pct,
                                      accounts=accts, dest_accounts=dests)
                    if shape == "mixed"
                    else lg.generate_payments(close_txs, accounts=accts,
                                              dest_accounts=dests))
            admitted = sum(1 for env in envs
                           if app.herder.recv_transaction(env) == 0)
            assert admitted == close_txs, f"only {admitted} admitted"
            sql0 = lm.root.reads_from_sql
            t0 = time.perf_counter()
            app.herder.manual_close()
            arms[which].append((time.perf_counter() - t0) * 1000.0)
            sql_reads[which] += lm.root.reads_from_sql - sql0
            phases[which].append(dict(lm.last_close_phases))
        pipeline.drain()
        deferred_ms, next_overlap_ms = _tail_overlap_from_ring(app)
        stats = dict(pipeline.stats)
        apply_stats = {k: v for k, v in app.parallel_apply.stats.items()
                       if not isinstance(v, list)}
        app.graceful_stop()

    def phase_p50(which, name):
        vals = [r.get(name, 0.0) for r in phases[which]
                if isinstance(r.get(name, 0.0), (int, float))]
        return round(statistics.median(vals), 2) if vals else None

    off_p50, on_p50 = _p50(arms["off"]), _p50(arms["on"])
    close_only = {
        which: _p50([r.get("total") for r in phases[which]
                     if isinstance(r.get("total"), (int, float))])
        for which in ("off", "on")}
    # tail ms reclaimed per close = deferred phases that no longer sit
    # on the close thread (the pipeline-off arm pays them inline)
    tail_off = sum(filter(None, (phase_p50("off", n)
                                 for n in ("commit", "meta", "gc"))))
    row.update({
        "shape": shape,
        "close_txs": close_txs,
        "closes_per_arm": n_closes,
        "workers": workers,
        "accounts": n_accounts,
        "off_close_p50_ms": off_p50,
        "on_close_p50_ms": on_p50,
        "close_phase_p50_ms": {
            "off": close_only["off"], "on": close_only["on"],
            "on_vs_off_pct": (
                round((close_only["on"] - close_only["off"])
                      / close_only["off"] * 100.0, 1)
                if close_only["off"] else None)},
        "off_close_p99_ms": _pct(arms["off"], 0.99),
        "on_close_p99_ms": _pct(arms["on"], 0.99),
        "on_vs_off_pct": (round((on_p50 - off_p50) / off_p50 * 100.0, 1)
                          if off_p50 else None),
        "verify_phase_p50_ms": {"off": phase_p50("off", "verify"),
                                "on": phase_p50("on", "verify")},
        "apply_phase_p50_ms": {"off": phase_p50("off", "apply"),
                               "on": phase_p50("on", "apply")},
        "tail_ms_reclaimed_p50": round(tail_off, 2),
        "tail_deferred_ms": {
            "p50": _p50(deferred_ms), "max": _pct(deferred_ms, 1.0),
            "samples": len(deferred_ms)},
        "tail_overlap_next_close_ms": {
            "p50": _p50(next_overlap_ms),
            "max": _pct(next_overlap_ms, 1.0),
            "samples": len(next_overlap_ms)},
        "tail_wait_p50_ms": phase_p50("on", "tail_wait"),
        "stage_p50_ms": phase_p50("on", "stage"),
        "prefetch_phase_p50_ms": {
            "off": phase_p50("off", "prefetch"),
            "on": phase_p50("on", "prefetch")},
        "prefetch": {
            "staged": stats["prefetch_staged"],
            "keys": stats["prefetch_keys"],
            "adopted": stats["prefetch_adopted"],
            "hit_rate": (round(stats["prefetch_adopted"]
                               / stats["prefetch_keys"], 4)
                         if stats["prefetch_keys"] else None)},
        "close_thread_sql_point_reads": sql_reads,
        "pipeline_stats": {k: (round(v, 4) if isinstance(v, float)
                               else v) for k, v in stats.items()},
        "batched_clusters": apply_stats.get("batched_clusters", 0),
        "native_hits": apply_stats.get("native_hits", 0),
    })
    _note(f"{backend} {shape}: round-trip off/on p50 {off_p50}/{on_p50}ms "
          f"({row['on_vs_off_pct']}%)  close-phase off/on p50 "
          f"{close_only['off']}/{close_only['on']}ms  tail reclaimed "
          f"{row['tail_ms_reclaimed_p50']}ms  deferred p50 "
          f"{row['tail_deferred_ms']['p50']}ms  prefetch hit "
          f"{row['prefetch']['hit_rate']}")
    return row


def parity_pass(backend: str, workers: int) -> dict:
    """The same deterministic workload, pipeline on (overlapping) vs off,
    on ``backend`` nodes: every per-close (ledger hash, bucket hash, meta
    bytes) must match."""
    from ._workloads import identical, run_workload

    with arm(backend) as row:
        on, _ = run_workload(True, eager=False,
                             PARALLEL_APPLY_WORKERS=workers,
                             **BACKENDS[backend])
        off, _ = run_workload(False, PARALLEL_APPLY_WORKERS=workers,
                              **BACKENDS[backend])
    ok = identical(on, off)
    row.update({"closes": len(on), "hashes_identical": ok,
                "meta_bytes_identical": ok,
                "last_ledger_hash": on[-1][0].hex()})
    _note(f"parity {backend}: {len(on)} closes, identical={ok}")
    if not ok:
        raise SystemExit("pipeline on/off parity FAILED")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--closes", type=int, default=8,
                    help="closes an arm (default 8)")
    ap.add_argument("--close-txs", type=int, default=1000)
    ap.add_argument("--dex-pct", type=int, default=30)
    ap.add_argument("--workers", type=int, default=2,
                    help="parallel apply workers (default 2)")
    ap.add_argument("--accounts", type=int, default=None,
                    help="seeded accounts (default 12 closes wide)")
    ap.add_argument("--lockdep-probe", action="store_true")
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2

    if args.lockdep_probe:
        rows = [lockdep_probe(b, max(4, args.closes), args.close_txs,
                              args.workers) for b in arms]
        doc = {"bench": "lockdep probe", "rows": rows}
        write_out(args.out, doc)
        emit(doc)
        return 0

    n_accounts = args.accounts or 12 * args.close_txs
    rows = []
    for i, shape in enumerate(("pay", "mixed")):
        for backend in turns(arms, i):
            rows.append(bench_workload(backend, shape, args.closes,
                                       args.close_txs, args.dex_pct,
                                       args.workers, n_accounts))
            emit(rows[-1])
    parity = [parity_pass(b, args.workers) for b in arms]
    doc = {
        "bench": "pipelined-close",
        "card": card(),
        "backends": arms,
        "workloads": rows,
        "parity": parity,
        "notes": (
            "alternating same-session A/B on a disk-backed node; 'on' "
            "arm overlaps the commit/meta/gc tail with the next cycle's "
            "admission/trigger/close (eager drain off); tail_deferred_ms "
            "= flight-recorder tail-span time past the close root's end; "
            "round-trip = manual_close wall incl. SCP/nomination, "
            "close_phase = the close-only span; parity compares "
            "per-close header/bucket hashes AND meta bytes pipeline-on "
            "vs off"),
    }
    write_out(args.out, doc)
    emit({k: doc[k] for k in ("bench", "card", "backends", "parity")}
         | {"workloads": [
             {k: r[k] for k in ("backend", "shape", "off_close_p50_ms",
                                "on_close_p50_ms", "on_vs_off_pct",
                                "close_phase_p50_ms", "tail_wait_p50_ms",
                                "crypto.verify.kernel-launches")}
             for r in rows]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
