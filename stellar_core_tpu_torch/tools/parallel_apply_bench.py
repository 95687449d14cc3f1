"""Native-apply A/B grid on the port, the counterpart of the repository's
``tools/parallel_apply_bench.py`` (its r16 grid): pay-heavy, mixed,
PATH-PAYMENT and live-POOL 1,000-tx closes through the full node close
path, over a workers 0/1/2/4 x fee-kernel on/off x PIPELINED_CLOSE on/off
grid; each grid arm alternates with a plain-sequential close IN THE SAME
SESSION so ledger-state drift (book growth, bucket spills) hits both arms
equally.  Every arm runs once a backend: on a ``cuda`` node (the close's
signature batch through the verify kernel, tallies on the card) and on a
``cpu`` node (host verifies and tallies) on the same host, back to back,
the order alternating arm by arm (``turns``), each row with the kernel's
launches; the result compares the two within this run.

The grid, per backend and per ``--shapes`` (default all four):
  - the scaling curve: workers 0/1/2/4, fee kernel on, no pipeline;
  - the fee/pipeline cross at workers 1 and 4;
  - pipelined workers 2 (pay and mixed);
  - forced-Python workers 4 (the native on/off column);
then the parity report over pathpay and pool: native fingerprints at
workers 0/2/4 and PYTHONHASHSEED 0/4242, each arm a subprocess, against
the forced-Python baseline.  The scaling summary reports the
workers=4/workers=1 whole-close speedup per (shape, fee, pipelined) and
flags any under 2x.

Extra modes:
  --fingerprint SHAPE WORKERS NATIVE   print per-close fingerprints (the
      subprocess arm of the parity report)
  --credit-smoke                       credit+path parity with a native
      hit-rate gate (>= 0.9)
  --fee-smoke                          NATIVE_FEE on/off parity with a
      fee-batch hit-rate gate (>= 0.9)

Prints one JSON line an arm and the result last; writes the result to a
file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.parallel_apply_bench
           [--shapes pay,mixed,pathpay,pool] [--closes N] [--close-txs N]
           [--dex-pct P] [--parity-closes N] [--no-parity]
           [--backend cuda|cpu] [--out PATH] [--device cpu]
"""
import argparse
import hashlib
import os
import statistics
import subprocess
import sys
import time

from . import (BACKENDS, add_backend_arg, arm, backends, card, emit,
               no_gpu, standalone_app, turns, work_dir, write_out)

PROG = "python -m stellar_core_tpu_torch.tools.parallel_apply_bench"
SHAPES = ("pay", "mixed", "pathpay", "pool")
PARITY_SHAPES = ("pathpay", "pool")
# the package's parent: where ``-m stellar_core_tpu_torch...`` imports from
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _note(msg):
    print(f"[parallel-apply-bench] {msg}", file=sys.stderr, flush=True)


def _mk_app(backend, close_txs, workers, native, fee=True, pipelined=False):
    kw = {}
    if pipelined:
        kw["PIPELINED_CLOSE"] = True
        kw["PIPELINED_CLOSE_EAGER_DRAIN"] = False  # real overlap
    app = standalone_app(
        backend,
        UPGRADE_DESIRED_MAX_TX_SET_SIZE=max(100, close_txs),
        DEFERRED_GC=True,
        PARALLEL_APPLY_WORKERS=workers,
        NATIVE_APPLY=native,
        NATIVE_FEE=native and fee,
        # workers<2 has no pool: the kernel applies clusters inline on
        # the close thread (the sequential-strip half of the claim)
        NATIVE_APPLY_INLINE=native and workers < 2,
        **kw)
    app.herder.manual_close()  # applies the max-tx-set-size upgrade
    return app


def _seed_shape(app, lg, shape, close_txs):
    """Workload seeding; pathpay needs maker offers closed for real."""
    lg.create_accounts(close_txs)
    if shape == "mixed":
        lg.setup_dex()
    elif shape == "credit":
        lg.setup_credit()
    elif shape == "pathpay":
        envs = lg.setup_path(hops=2, makers=8)
        admitted = sum(1 for env in envs
                       if app.herder.recv_transaction(env) == 0)
        assert admitted == len(envs), f"maker seeding: {admitted}"
        app.herder.manual_close()
    elif shape == "pool":
        # live constant-product pools on every hop pair
        lg.setup_pool(hops=2)


def _generate(lg, shape, close_txs, dex_pct):
    if shape == "mixed":
        return lg.generate_mixed(close_txs, dex_percent=dex_pct)
    if shape == "credit":
        return lg.generate_credit_mix(close_txs, trust_pct=10)
    if shape == "pathpay":
        return lg.generate_path_payments(close_txs)
    if shape == "pool":
        return lg.generate_pool_payments(close_txs)
    return lg.generate_payments(close_txs)


def _counters(app, prefix: str) -> dict:
    return {name[len(prefix):]: m.count
            for name, m in sorted(app.metrics._metrics.items())
            if name.startswith(prefix) and m.count}


def _native_taxonomy(app) -> dict:
    """The per-op-type hit/decline counters (executor breakout)."""
    out = {"hit": {}, "decline": {}}
    for name, m in sorted(app.metrics._metrics.items()):
        if name.startswith("apply.native.hit."):
            out["hit"][name[len("apply.native.hit."):]] = m.count
        elif name.startswith("apply.native.decline."):
            out["decline"][name[len("apply.native.decline."):]] = m.count
    return out


def _p50(xs):
    return round(statistics.median(xs), 2) if xs else None


def _pct(xs, q):
    if not xs:
        return None
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(q * len(xs)))], 2)


def bench_workload(backend: str, shape: str, pattern: str, n_closes: int,
                   close_txs: int, dex_pct: int, workers: int,
                   native: bool, fee: bool = True,
                   pipelined: bool = False) -> dict:
    from ..simulation.load_generator import LoadGenerator

    with arm(backend) as row:
        app = _mk_app(backend, close_txs, workers, native, fee=fee,
                      pipelined=pipelined)
        lg = LoadGenerator(app)
        lg.payment_pattern = pattern
        _seed_shape(app, lg, shape, close_txs)
        arms = {"sequential": [], "grid": []}
        phases = {"sequential": [], "grid": []}
        plan_rows = []
        for i in range(2 * n_closes):
            which = "grid" if i % 2 else "sequential"
            app.parallel_apply.enabled = (which == "grid")
            envs = _generate(lg, shape, close_txs, dex_pct)
            admitted = sum(1 for env in envs
                           if app.herder.recv_transaction(env) == 0)
            assert admitted == close_txs, f"only {admitted} admitted"
            t0 = time.perf_counter()
            app.herder.manual_close()
            arms[which].append((time.perf_counter() - t0) * 1000.0)
            phases[which].append(dict(app.ledger_manager.last_close_phases))
            if which == "grid":
                plan_rows.append(dict(app.parallel_apply.last_plan_stats))
        stats = {k: v for k, v in app.parallel_apply.stats.items()
                 if not isinstance(v, list)}
        stats["escape_reasons"] = app.parallel_apply.stats["escapes"][-4:]
        stats["decline_reasons"] = \
            app.parallel_apply.stats["native_decline_reasons"][-4:]
        taxonomy = _native_taxonomy(app)
        fee_counters = _counters(app, "apply.native.fee.")
        m = app.metrics._metrics.get("apply.native.tail_encode.hit")
        tail_hits = m.count if m is not None else 0
        app.graceful_stop()

    def phase_p50(which, name):
        vals = [r.get(name, 0.0) for r in phases[which]
                if isinstance(r.get(name, 0.0), (int, float))]
        return round(statistics.median(vals), 2) if vals else None

    seq_p50, grid_p50 = _p50(arms["sequential"]), _p50(arms["grid"])
    clusters = stats["native_hits"] + stats["native_declines"] + \
        stats["native_off"]
    row.update({
        "shape": shape,
        "pattern": pattern,
        "close_txs": close_txs,
        "closes_per_arm": n_closes,
        "workers": workers,
        "native": native,
        "fee_kernel": native and fee,
        "pipelined": pipelined,
        "seq_close_p50_ms": seq_p50,
        "grid_close_p50_ms": grid_p50,
        "grid_close_p99_ms": _pct(arms["grid"], 0.99),
        "seq_close_p99_ms": _pct(arms["sequential"], 0.99),
        "grid_vs_seq_pct": (
            round((grid_p50 - seq_p50) / seq_p50 * 100.0, 1)
            if seq_p50 else None),
        "seq_apply_p50_ms": phase_p50("sequential", "apply"),
        "grid_apply_p50_ms": phase_p50("grid", "apply"),
        "grid_plan_p50_ms": phase_p50("grid", "plan"),
        "seq_verify_p50_ms": phase_p50("sequential", "verify"),
        "grid_verify_p50_ms": phase_p50("grid", "verify"),
        "seq_fee_phase_p50_ms": phase_p50("sequential", "fee"),
        "grid_fee_phase_p50_ms": phase_p50("grid", "fee"),
        "grid_tail_wait_p50_ms": phase_p50("grid", "tail_wait"),
        "fee_batch": fee_counters,
        "tail_encode_hits": tail_hits,
        "native_hit_rate": (
            round(stats["native_hits"] / clusters, 4) if clusters else None),
        "native_taxonomy": taxonomy,
        "apply_stats": stats,
    })
    if plan_rows:
        def med(key):
            vals = [r.get(key) for r in plan_rows
                    if isinstance(r.get(key), (int, float))]
            return round(statistics.median(vals), 2) if vals else None

        row["plan"] = {
            "clusters_p50": med("clusters"),
            "kernel_clusters_p50": med("kernel_clusters"),
            "max_width_p50": med("max_width"),
            "conflict_rate_p50": med("conflict_rate"),
            "preplanned": any(r.get("preplanned") for r in plan_rows),
            "unplanned_reasons": sorted({
                r["unplanned"] for r in plan_rows if "unplanned" in r}),
        }
    _note(f"{backend} {shape}/{pattern} w={workers} native={int(native)} "
          f"fee={int(fee)} pipe={int(pipelined)}: "
          f"seq p50 {seq_p50}ms  grid p50 {grid_p50}ms "
          f"({row['grid_vs_seq_pct']}%)  aborts={stats['aborts']} "
          f"hit_rate={row['native_hit_rate']}")
    return row


# -- parity (fingerprints, subprocess hash-seed arms) -------------------------

def fingerprint_workload(shape: str, workers: int, native: bool,
                         n_closes: int, close_txs: int, fee: bool = True,
                         backend: str = "cuda"):
    """Per-close (ledger hash, bucket hash, sha256(meta)) fingerprints
    of a deterministic ``shape`` workload on a ``backend`` node — the
    parity oracle — and the node's apply stats."""
    from ..simulation.load_generator import LoadGenerator
    from ..xdr import types as T

    app = _mk_app(backend, close_txs, workers, native, fee=fee)
    lg = LoadGenerator(app)
    lg.payment_pattern = "pairs"
    _seed_shape(app, lg, shape, close_txs)
    fps = []

    def close():
        app.herder.manual_close()
        meta = app._meta_stream[-1] if app._meta_stream else None
        fps.append((
            app.ledger_manager.last_closed_hash().hex(),
            app.bucket_manager.get_bucket_list_hash().hex(),
            hashlib.sha256(T.LedgerCloseMeta.encode(meta)).hexdigest()
            if meta is not None else ""))

    for _ in range(n_closes):
        envs = _generate(lg, shape, close_txs, 30)
        admitted = sum(1 for env in envs
                       if app.herder.recv_transaction(env) == 0)
        assert admitted == close_txs, f"only {admitted} admitted"
        close()
    stats = dict(app.parallel_apply.stats)
    stats["fee_batch"] = _counters(app, "apply.native.fee.")
    app.graceful_stop()
    return fps, stats


def _subprocess_fingerprints(backend, shape, workers, native, n_closes,
                             close_txs, hashseed, cwd) -> list:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = str(hashseed)
    env["PYTHONPATH"] = os.pathsep.join(
        [PKG_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "stellar_core_tpu_torch.tools."
           "parallel_apply_bench", "--fingerprint", shape, str(workers),
           str(int(native)), "--parity-closes", str(n_closes),
           "--close-txs", str(close_txs), "--backend", backend]
    if BACKENDS[backend]["device"] == "cpu":
        cmd += ["--device", "cpu"]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [tuple(line.split()) for line in
            proc.stdout.strip().splitlines()]


def parity_report(backend, shapes, n_closes, close_txs) -> dict:
    """Native-on fingerprints across workers 0/2/4 and PYTHONHASHSEED
    0/4242 (every arm a subprocess so the hash seed truly varies) must
    all equal the forced-Python baseline, on ``backend`` nodes."""
    report = {"backend": backend, "close_txs": close_txs,
              "closes": n_closes, "shapes": {}}
    identical = True
    with work_dir("parallel-apply-parity") as cwd:
        for shape in shapes:
            def fp(workers, native, seed):
                return _subprocess_fingerprints(
                    backend, shape, workers, native, n_closes, close_txs,
                    seed, cwd)

            base = fp(0, False, 0)
            arms = {f"native_w{w}_seed0": fp(w, True, 0) for w in (0, 2, 4)}
            arms["native_w2_seed4242"] = fp(2, True, 4242)
            arms["python_w2_seed4242"] = fp(2, False, 4242)
            shape_ok = all(x == base for x in arms.values())
            identical = identical and shape_ok
            report["shapes"][shape] = {
                "identical": shape_ok,
                "arms": sorted(arms),
                "baseline_last_close": list(base[-1]) if base else None,
            }
            _note(f"parity {backend} {shape}: "
                  f"{'identical' if shape_ok else 'DIVERGED'} over "
                  f"{len(arms)} arms x {len(base)} closes")
    report["hashes_and_meta_identical"] = identical
    return report


# -- the hit-rate gates -------------------------------------------------------

def credit_smoke(backend: str, n_closes: int = 2,
                 close_txs: int = 200) -> dict:
    """Small credit+path native-vs-Python parity + hit-rate gate: the
    smoke fails under a 0.9 native cluster-hit rate."""
    report = {"metric": "native_credit_smoke", "backend": backend,
              "close_txs": close_txs, "closes": n_closes, "shapes": {}}
    ok = True
    for shape in ("credit", "pathpay"):
        base, _ = fingerprint_workload(shape, 0, False, n_closes,
                                       close_txs, backend=backend)
        fps, stats = fingerprint_workload(shape, 2, True, n_closes,
                                          close_txs, backend=backend)
        clusters = stats["native_hits"] + stats["native_declines"] + \
            stats["native_off"]
        hit_rate = stats["native_hits"] / clusters if clusters else 0.0
        row = {
            "parity_identical": fps == base,
            "native_hit_rate": round(hit_rate, 4),
            "aborts": stats["aborts"],
            "native_hits": stats["native_hits"],
            "native_declines": stats["native_declines"],
            "decline_reasons": stats["native_decline_reasons"][-4:],
        }
        row["ok"] = (row["parity_identical"] and row["aborts"] == 0
                     and hit_rate >= 0.9)
        ok = ok and row["ok"]
        report["shapes"][shape] = row
        _note(f"credit-smoke {backend} {shape}: parity="
              f"{row['parity_identical']} hit_rate={row['native_hit_rate']}"
              f" aborts={row['aborts']} -> {'ok' if row['ok'] else 'RED'}")
    report["ok"] = ok
    return report


def fee_smoke(backend: str, n_closes: int = 2, close_txs: int = 200) -> dict:
    """The fee-phase gate: a mixed workload with the batched
    ``charge_fees`` kernel on vs ``NATIVE_FEE=0`` must close
    bit-identical (hashes AND meta), and the fee batch must carry the
    phase — hit rate >= 0.9 of closes."""
    base, _ = fingerprint_workload("mixed", 2, True, n_closes, close_txs,
                                   fee=False, backend=backend)
    fps, stats = fingerprint_workload("mixed", 2, True, n_closes,
                                      close_txs, fee=True, backend=backend)
    fees = stats.get("fee_batch", {})
    hits, declines = fees.get("hit", 0), fees.get("decline", 0)
    batches = hits + declines
    hit_rate = hits / batches if batches else 0.0
    report = {
        "metric": "native_fee_smoke",
        "backend": backend,
        "close_txs": close_txs,
        "closes": n_closes,
        "parity_identical": fps == base,
        "fee_batch_hit_rate": round(hit_rate, 4),
        "fee_batch": fees,
        "ok": fps == base and batches > 0 and hit_rate >= 0.9,
    }
    _note(f"fee-smoke {backend}: parity={report['parity_identical']} "
          f"hit_rate={report['fee_batch_hit_rate']} "
          f"({hits} hits / {declines} declines) -> "
          f"{'ok' if report['ok'] else 'RED'}")
    return report


# -- the grid -----------------------------------------------------------------

def grid_arms(shapes) -> list:
    """(shape, workers, native, fee, pipelined) of every grid arm, in run
    order: the scaling curve, the fee/pipeline cross at workers 1 and 4,
    pipelined workers 2 (pay, mixed), forced-Python workers 4."""
    out = [(s, w, True, True, False) for s in shapes for w in (0, 1, 2, 4)]
    out += [(s, w, True, fee, pipe) for s in shapes
            for fee, pipe in ((True, True), (False, False), (False, True))
            for w in (1, 4)]
    out += [(s, 2, True, True, True) for s in shapes if s in ("pay", "mixed")]
    out += [(s, 4, False, True, False) for s in shapes]
    return out


def _find(rows, backend, shape, workers, native, fee=True, pipelined=False):
    for r in rows:
        if (r["backend"], r["shape"], r["workers"], r["native"],
                r["fee_kernel"], r["pipelined"]) == (
                backend, shape, workers, native, native and fee, pipelined):
            return r
    return None


def scaling_summary(rows, backend, shapes) -> tuple:
    """workers=4 / workers=1 whole-close speedup per (shape, fee,
    pipelined) combo of ``backend``; under 2x is a flagged note."""
    scaling, notes = [], []
    for shape in shapes:
        for fee, pipelined in ((True, False), (True, True),
                               (False, False), (False, True)):
            w1 = _find(rows, backend, shape, 1, True, fee, pipelined)
            w4 = _find(rows, backend, shape, 4, True, fee, pipelined)
            if not (w1 and w1.get("grid_close_p50_ms")
                    and w4 and w4.get("grid_close_p50_ms")):
                continue
            speedup = round(
                w1["grid_close_p50_ms"] / w4["grid_close_p50_ms"], 2)
            # each arm normalised by its OWN same-session sequential
            # baseline: later arms in one process run on a bigger heap
            norm = None
            if w1.get("seq_close_p50_ms") and w4.get("seq_close_p50_ms"):
                norm = round(
                    (w1["grid_close_p50_ms"] / w1["seq_close_p50_ms"])
                    / (w4["grid_close_p50_ms"] / w4["seq_close_p50_ms"]), 2)
            scaling.append({"backend": backend, "shape": shape,
                            "fee_kernel": fee, "pipelined": pipelined,
                            "w1_close_p50_ms": w1["grid_close_p50_ms"],
                            "w4_close_p50_ms": w4["grid_close_p50_ms"],
                            "w4_vs_w1_speedup": speedup,
                            "w4_vs_w1_speedup_seq_normalized": norm,
                            "under_2x": speedup < 2.0})
            if speedup < 2.0:
                notes.append(
                    f"{backend} {shape} fee={int(fee)} pipe={int(pipelined)}"
                    f": workers=4/workers=1 speedup {speedup}x < 2x "
                    f"(w1 {w1['grid_close_p50_ms']}ms -> "
                    f"w4 {w4['grid_close_p50_ms']}ms, "
                    f"seq-normalized {norm}x)")
    return scaling, notes


def cuda_vs_cpu(rows) -> list:
    """Each grid arm's whole-close, apply and verify p50 on the ``cuda``
    node beside the ``cpu`` node's, where both ran."""
    def key(r):
        return (r["shape"], r["workers"], r["native"], r["fee_kernel"],
                r["pipelined"])

    cpu = {key(r): r for r in rows if r["backend"] == "cpu"}
    out = []
    for r in rows:
        c = cpu.get(key(r)) if r["backend"] == "cuda" else None
        if c is None:
            continue
        out.append({
            "shape": r["shape"], "workers": r["workers"],
            "native": r["native"], "fee_kernel": r["fee_kernel"],
            "pipelined": r["pipelined"],
            **{m: {"cuda": r[m], "cpu": c[m]} for m in (
                "grid_close_p50_ms", "grid_apply_p50_ms",
                "grid_verify_p50_ms")},
            "cuda_vs_cpu_pct": (
                round((r["grid_close_p50_ms"] - c["grid_close_p50_ms"])
                      / c["grid_close_p50_ms"] * 100.0, 1)
                if c["grid_close_p50_ms"] else None)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated shapes of the grid (default all)")
    ap.add_argument("--closes", type=int, default=3,
                    help="closes a side of each grid arm (default 3)")
    ap.add_argument("--close-txs", type=int, default=1000)
    ap.add_argument("--dex-pct", type=int, default=30)
    ap.add_argument("--parity-closes", type=int, default=2)
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the parity report's subprocesses")
    ap.add_argument("--fingerprint", nargs=3,
                    metavar=("SHAPE", "WORKERS", "NATIVE"),
                    help="print per-close fingerprints and exit")
    ap.add_argument("--credit-smoke", action="store_true")
    ap.add_argument("--fee-smoke", action="store_true")
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    shapes = [s for s in args.shapes.split(",") if s]
    bad = sorted(set(shapes) - set(SHAPES))
    if bad:
        ap.error(f"unknown shapes {bad}")

    if args.fingerprint:
        shape, workers, native = args.fingerprint
        fps, _ = fingerprint_workload(shape, int(workers), bool(int(native)),
                                      args.parity_closes, args.close_txs,
                                      backend=arms[0])
        for lh, bh, mh in fps:
            print(lh, bh, mh)
        return 0

    if args.credit_smoke or args.fee_smoke:
        smoke = credit_smoke if args.credit_smoke else fee_smoke
        reports = [smoke(b) for b in arms]
        doc = {"smoke": reports, "ok": all(r["ok"] for r in reports),
               "card": card()}
        write_out(args.out, doc)
        emit(doc)
        return 0 if doc["ok"] else 1

    rows = []
    for i, (shape, workers, native, fee, pipelined) in enumerate(
            grid_arms(shapes)):
        for backend in turns(arms, i):
            rows.append(bench_workload(
                backend, shape, "pairs", args.closes, args.close_txs,
                args.dex_pct, workers, native, fee=fee,
                pipelined=pipelined))
            emit(rows[-1])
    parity_shapes = [s for s in shapes if s in PARITY_SHAPES]
    parity = ([parity_report(b, parity_shapes, args.parity_closes,
                             args.close_txs) for b in arms]
              if parity_shapes and not args.no_parity else [])
    scaling, notes = [], []
    for backend in arms:
        s, n = scaling_summary(rows, backend, shapes)
        scaling += s
        notes += n
    if notes and (os.cpu_count() or 1) < 4:
        notes.insert(0, (
            f"context: host has cpu_count={os.cpu_count()} — workers=4 "
            f"cannot out-schedule workers=1 on wall-clock here; judge the "
            f"kernel by grid_vs_seq_pct per arm"))
    doc = {
        "metric": "parallel_apply_native_ab",
        "host": {"cpu_count": os.cpu_count()},
        "card": card(),
        "backends": arms,
        "shapes": shapes,
        "workloads": rows,
        "aborts_total": sum(r["apply_stats"]["aborts"] for r in rows),
        "parity": parity,
        "parity_identical": all(p["hashes_and_meta_identical"]
                                for p in parity),
        "scaling": scaling,
        "regression_notes": notes,
        "cuda_vs_cpu": cuda_vs_cpu(rows),
    }
    write_out(args.out, doc)
    emit({k: doc[k] for k in ("metric", "card", "backends", "shapes",
                              "aborts_total", "parity_identical",
                              "regression_notes", "cuda_vs_cpu")}
         | {"workloads": [
             {k: r[k] for k in ("backend", "shape", "workers", "native",
                                "fee_kernel", "pipelined",
                                "seq_close_p50_ms", "grid_close_p50_ms",
                                "grid_vs_seq_pct", "native_hit_rate",
                                "crypto.verify.kernel-launches")}
             for r in rows]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
