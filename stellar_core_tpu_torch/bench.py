"""Headline benchmark of the port: the BASELINE north-star configs on the
real herder path, on the GPU.  The counterpart of the repository's root
``bench.py`` (the JAX package's).

    python -m stellar_core_tpu_torch.bench [--device cpu]

Config #2 — tx-signature verifies/s on a large TxSetFrame: ``BENCH_N``
LoadGenerator payment envelopes go through ``TxSetFrame.make_from_wire`` ->
``collect_signature_batch``, padded to a ``SIG_BATCH_BUCKETS`` size, and
the verify stage (``bench_device.run``) runs them through the CUDA kernel.
Every verdict must be true and the kernel's verdicts must equal the plain
torch version's on the same padded batch.  The baseline is the sequential
CPU path on the same host: 2,000 ``crypto.ed25519.raw_verify`` calls
(OpenSSL through ``cryptography`` where installed, the architecture of the
reference's PubKeyUtils::verifySig, ref src/crypto/SecretKey.cpp:428).
The close's own seam, ``TxSetFrame.prevalidate_signatures`` (batch
assembly with its hint matching, the copy, the launch and the readback), is
timed on the same set.

Config #1 — ledger-close p50 / p99 / max of ``BENCH_CLOSE_TXS``-tx ledgers
over ``BENCH_CLOSES`` closes a shape (payments, then mixed with
``BENCH_DEX_PCT``% DEX offers, then mixed again with tracing off): node A
runs ``CRYPTO_BACKEND="cuda"`` (tallies ``"tensor"``) on the card, node B
the ``"cpu"`` / ``"host"`` tiers on the same host.  The envelopes are
generated once and the same bytes are submitted to both; both nodes must
end every close with the same ledger hash.  The nodes take turns to close
first: the process's one garbage collection a ledger falls in the first
close of that ledger.

Prints the flight-recorder line (per-op-type apply time, the tracing-off
A/B, per-phase medians of node A) and the config #2 stage line as earlier
stdout lines, and ONE last line with the JAX bench line's keys plus the
``cpu`` node's close p50.  Writes no file.

Without a GPU this exits non-zero.  ``--device cpu`` runs node A's batch and
the verify stage through the plain torch version on the CPU: the only CPU
route, for tests.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

PHASES = ("prefetch", "verify", "fee", "apply", "upgrades", "hash", "bucket",
          "spill_wait", "bucket_hash", "commit", "meta", "gc", "total")
LINE_PHASES = ("verify", "fee", "apply", "bucket", "spill_wait",
               "bucket_hash", "hash", "commit", "gc", "total")
CPU_BASELINE_N = 2000


def _note(msg) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _node(crypto_backend: str, close_txs: int, device=None):
    """A started standalone node (``test_config``, the production
    deferred-GC policy) with the max-tx-set-size upgrade applied by its
    first close, as the reference's load tests raise it."""
    from .main import Application, test_config
    from .utils.clock import ClockMode, VirtualClock

    on_device = crypto_backend == "cuda"
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), test_config(
        UPGRADE_DESIRED_MAX_TX_SET_SIZE=max(100, close_txs),
        CRYPTO_BACKEND=crypto_backend,
        SCP_TALLY_BACKEND="tensor" if on_device else "host",
        DEFERRED_GC=True), device=device if on_device else None)
    app.start()
    app.herder.manual_close()
    assert app.ledger_manager.last_closed_header().maxTxSetSize >= close_txs
    return app


def build_tx_set(app, lg, n_sigs: int):
    """``n_sigs`` LoadGenerator payments as a peer's TxSetFrame on
    ``app``'s last closed ledger, its signature batch, and the seconds of
    each step."""
    from .herder.tx_set import TxSetFrame
    from .xdr import types as T

    t0 = time.perf_counter()
    envs = lg.generate_payments(n_sigs)
    t1 = time.perf_counter()
    tx_set = TxSetFrame.make_from_wire(
        app.config.network_id(), T.TransactionSet.make(
            previousLedgerHash=app.ledger_manager.last_closed_hash(),
            txs=envs))
    t2 = time.perf_counter()
    triples, _ = tx_set.collect_signature_batch()
    t3 = time.perf_counter()
    return tx_set, triples, {"generate_s": t1 - t0,
                             "make_from_wire_s": t2 - t1,
                             "collect_s": t3 - t2}


def config2(app, lg, n_sigs: int, device) -> tuple:
    """The config #2 stage on node ``app``; returns its line and its
    batch (pk, sg, mg)."""
    from . import bench_device
    from .crypto import ed25519 as ed
    from .ops import ed25519_kernel
    from .utils.device import signature_columns

    _note(f"building {n_sigs} payment envelopes")
    tx_set, triples, build = build_tx_set(app, lg, n_sigs)
    pk, sg, mg = signature_columns(triples)
    n = pk.shape[0]
    _note(f"{n} triples: {build}")

    n_base = min(CPU_BASELINE_N, n)
    t0 = time.perf_counter()
    for i in range(n_base):
        assert ed.raw_verify(bytes(pk[i]), bytes(sg[i]), bytes(mg[i]))
    cpu_rate = n_base / (time.perf_counter() - t0)
    _note(f"cpu baseline: {cpu_rate:.0f}/s")

    stage = bench_device.run(pk, sg, mg, device=device)
    ok = stage.pop("verdicts")
    padded = stage.pop("padded")
    if not ok.all():
        raise AssertionError(f"{int((~ok).sum())} of {ok.size} verdicts "
                             "false on the padded batch")
    # the kernel against the plain torch version on the same padded batch
    # (the CPU route's stage ran the plain version itself)
    equal, plain_s = None, None
    if stage["kernel"] == "cuda":
        t0 = time.perf_counter()
        plain = ed25519_kernel.verify_batch(*(
            torch.as_tensor(x, device=device) for x in padded)).cpu().numpy()
        plain_s = time.perf_counter() - t0
        if not np.array_equal(plain, ok):
            raise AssertionError(f"the kernel differs from the plain version "
                                 f"in {int((plain != ok).sum())} rows")
        equal = True

    t0 = time.perf_counter()
    verdicts = tx_set.prevalidate_signatures(use_device=True, device=device)
    prevalidate_s = time.perf_counter() - t0
    if len(verdicts) != len(set(triples)) or not all(verdicts.values()):
        raise AssertionError("prevalidate_signatures refused a signature")
    digest = hashlib.sha256(pk.tobytes() + sg.tobytes() + mg.tobytes())
    return {"phase": "config2", "n_signatures": n, **build,
            "triples_sha256": digest.hexdigest(),
            "cpu_verifies_per_sec": cpu_rate, "cpu_baseline_n": n_base,
            **stage, "verdicts_true": int(ok.sum()),
            "kernel_equal_to_plain": equal, "plain_s": plain_s,
            "prevalidate_s": prevalidate_s,
            "prevalidate_verifies_per_sec": n / prevalidate_s}, (pk, sg, mg)


def _clock_to_next_close(app) -> None:
    """Move the node's virtual clock up to its next close time (the last
    one's + 1 s, which a manual close takes): a clock left at its start
    falls behind the ledgers, and past 60 closes the herder would refuse
    the close time as a slip into the future."""
    t = app.ledger_manager.last_closed_header().scpValue.closeTime + 1
    if t > app.clock.now():
        app.clock.set_current_virtual_time(t)


def run_closes(a, b, lg, shape: str, n_closes: int, close_txs: int,
               dex_pct: int) -> dict:
    """``n_closes`` closes of ``close_txs`` envelopes on node A and node B
    (each timed, with its phases), fed the same envelopes; the nodes'
    ledger hashes must agree after every close.

    The nodes share the process, and its garbage collection runs once a
    ledger, in the close of whichever node closes that ledger first
    (``LedgerManager._post_close_gc``): the nodes take turns to close
    first, so each pays it on every other close."""
    out = {"a_ms": [], "b_ms": [], "phases": [], "b_phases": []}
    for i in range(n_closes):
        envs = (lg.generate_mixed(close_txs, dex_percent=dex_pct)
                if shape == "mixed" else lg.generate_payments(close_txs))
        for app in (a, b):
            admitted = sum(1 for env in envs
                           if app.herder.recv_transaction(env) == 0)
            assert admitted == close_txs, \
                f"only {admitted}/{close_txs} txs admitted"
        order = ((a, "a_ms"), (b, "b_ms"))
        for app, key in order if i % 2 == 0 else order[::-1]:
            _clock_to_next_close(app)
            t0 = time.perf_counter()
            app.herder.manual_close()
            if app.device is not None and app.device.type == "cuda":
                torch.cuda.synchronize(app.device)
            out[key].append((time.perf_counter() - t0) * 1000)
            # the upgraded maxTxSetSize must have let the WHOLE batch
            # close: a trimmed set would silently measure less
            assert app.herder.tx_queue.size() == 0, "close left txs"
        out["phases"].append(dict(a.ledger_manager.last_close_phases))
        out["b_phases"].append(dict(b.ledger_manager.last_close_phases))
        ha, hb = (app.ledger_manager.last_closed_hash() for app in (a, b))
        if ha != hb:
            raise AssertionError(
                f"ledger {a.ledger_manager.last_closed_seq()}: the cuda "
                f"node's hash {ha.hex()} != the cpu node's {hb.hex()}")
    return out


def _p99(xs):
    return sorted(xs)[max(0, math.ceil(len(xs) * 0.99) - 1)]


def _median_phases(rows, names, ndigits) -> dict:
    return {ph: round(statistics.median(r.get(ph, 0.0) for r in rows),
                      ndigits) for ph in names}


def flight_recorder_line(a, mixed: dict, disabled: dict, close_txs: int,
                         dex_pct: int) -> dict:
    """Per-op-type apply attribution and the tracing-off A/B of node A's
    mixed closes (the JAX bench's trace line, printed, not written)."""
    from .utils.tracing import Tracer

    rows = mixed["phases"]
    op_keys = sorted({k for r in rows for k in (r.get("apply_ops") or {})})
    apply_op_type_ms = {
        k: round(statistics.median((r.get("apply_ops") or {}).get(k, 0.0)
                                   for r in rows), 3) for k in op_keys}
    # disabled-span microcost: a Span always takes two perf_counter reads;
    # recording is skipped when disabled
    dis = Tracer(enabled=False)
    n_probe = 200_000
    t0 = time.perf_counter()
    for _ in range(n_probe):
        with dis.span("bench.overhead.probe"):
            pass
    disabled_span_ns = (time.perf_counter() - t0) / n_probe * 1e9
    rec = a.tracer.get_close()
    spans_per_close = len(rec.spans) if rec is not None else 0
    p50 = statistics.median(mixed["a_ms"])
    return {
        "metric": "ledger_close_flight_recorder",
        "close_txs": close_txs,
        "close_shape": f"mixed({dex_pct}% dex)",
        "close_samples": len(mixed["a_ms"]),
        "apply_op_type_ms": apply_op_type_ms,
        "close_p50_ms_tracing_enabled": round(p50, 2),
        "close_p50_ms_tracing_disabled": round(
            statistics.median(disabled["a_ms"]), 2),
        "spans_per_close": spans_per_close,
        "disabled_span_cost_ns": round(disabled_span_ns, 1),
        "tracing_disabled_overhead_pct_of_close_p50": round(
            disabled_span_ns * 1e-6 * spans_per_close / p50 * 100.0, 4),
        "close_phase_ms_median": _median_phases(rows, PHASES, 3),
    }


def run(device, n_sigs: int = 100_000, n_closes: int = 24,
        close_txs: int = 1000, dex_pct: int = 30, emit=None) -> dict:
    """Both configs on ``device`` (node A's, and the verify stage's).
    ``emit`` gets the config #2 line and the flight-recorder line as they
    are made.  Returns ``{"config2", "trace", "line"}`` (the lines) and
    ``"batch"``, the config #2 triples as (pk, sg, mg) numpy arrays.
    Raises on any false verdict, kernel != plain, or ledger hash that
    differs between the nodes."""
    gc_was_enabled = gc.isenabled()
    try:
        return _run(torch.device(device), n_sigs, n_closes, close_txs,
                    dex_pct, emit or (lambda line: None))
    finally:
        # the nodes' DEFERRED_GC froze the heap and turned the process's
        # automatic collection off: the caller gets its collector back
        if gc_was_enabled:
            gc.unfreeze()
            gc.enable()


def _run(device, n_sigs, n_closes, close_txs, dex_pct, emit) -> dict:
    from .simulation.load_generator import LoadGenerator

    t0 = time.perf_counter()
    a = _node("cuda", close_txs, device)
    b = _node("cpu", close_txs)
    if a.ledger_manager.last_closed_hash() != \
            b.ledger_manager.last_closed_hash():
        raise AssertionError("the nodes' first ledgers differ")
    # the same bulk seeding on both nodes; envelopes come from A's
    # generators only, and both nodes receive the same bytes
    gens = [LoadGenerator(app) for app in (a, b)]
    for lg in gens:
        lg.create_accounts(min(n_sigs, CPU_BASELINE_N))
    setup_s = time.perf_counter() - t0

    c2, batch = config2(a, gens[0], n_sigs, device)
    c2["setup_s"] = setup_s
    emit(c2)

    # fresh generators: the signature batch above advanced the first
    # generator's sequence tracker without applying anything, so its next
    # envelopes would be rejected as sequence gaps
    gens = [LoadGenerator(app) for app in (a, b)]
    for lg in gens:
        lg.create_accounts(max(close_txs, 1), prefix=b"close-bench")
        # MIXED shape: payments + DEX offers (close numbers must not be
        # payments-only; ref LoadGenMode::MIXED_TXS)
        lg.setup_dex()
    lg = gens[0]
    pay = run_closes(a, b, lg, "pay", n_closes, close_txs, dex_pct)
    mixed = run_closes(a, b, lg, "mixed", n_closes, close_txs, dex_pct)
    # tracing-disabled A/B in the same session: the flight recorder's span
    # instrumentation must cost <1% of close p50 when recording is off
    a.tracer.enabled = False
    disabled = run_closes(a, b, lg, "mixed", n_closes, close_txs, dex_pct)
    a.tracer.enabled = True
    close_p50 = statistics.median(mixed["a_ms"])
    _note(f"close p50: {close_p50:.1f} ms (cuda node), "
          f"{statistics.median(mixed['b_ms']):.1f} ms (cpu node) at "
          f"{close_txs} txs over {n_closes} closes")

    trace = flight_recorder_line(a, mixed, disabled, close_txs, dex_pct)
    emit(trace)

    rate = c2["rate"]
    line = {
        "metric": "ed25519_verifies_per_sec_txset",
        "value": round(rate, 1),
        "unit": "verifies/s",
        "vs_baseline": round(rate / c2["cpu_verifies_per_sec"], 2),
        "cpu_verifies_per_sec": round(c2["cpu_verifies_per_sec"], 1),
        "n_signatures": c2["n_signatures"],
        "n_padded": c2["n_padded"],
        "kernel": c2["kernel"],
        "device": c2["device"],
        "kernel_ms": c2["kernel_ms"],
        "verdicts_true": c2["verdicts_true"],
        "kernel_equal_to_plain": c2["kernel_equal_to_plain"],
        "prevalidate_verifies_per_sec": round(
            c2["prevalidate_verifies_per_sec"], 1),
        "ledger_close_p50_ms": round(close_p50, 1),
        "ledger_close_p99_ms": round(_p99(mixed["a_ms"]), 1),
        "ledger_close_max_ms": round(max(mixed["a_ms"]), 1),
        "ledger_close_p50_ms_cpu_backend": round(
            statistics.median(mixed["b_ms"]), 1),
        "ledger_close_p99_ms_cpu_backend": round(_p99(mixed["b_ms"]), 1),
        "close_samples": len(mixed["a_ms"]),
        "close_txs": close_txs,
        "close_shape": f"mixed({dex_pct}% dex)",
        "ledger_close_p50_ms_payments": round(
            statistics.median(pay["a_ms"]), 1),
        "ledger_close_p50_ms_payments_cpu_backend": round(
            statistics.median(pay["b_ms"]), 1),
        "close_ledger_hashes_equal": True,
        "apply_op_type_ms": trace["apply_op_type_ms"],
        "close_phase_ms": _median_phases(mixed["phases"], LINE_PHASES, 2),
        "close_phase_ms_cpu_backend": _median_phases(mixed["b_phases"],
                                                     LINE_PHASES, 2),
        "bucket_merge_stats": {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in a.bucket_manager.bucket_list.stats.items()},
    }
    return {"config2": c2, "trace": trace, "line": line, "batch": batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stellar_core_tpu_torch.bench")
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="run node A's batch and the verify stage through "
                         "the plain torch version on the CPU (tests); "
                         "default: the GPU")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("bench: no CUDA device is available (--device cpu runs the "
              "plain torch version on the CPU)", file=sys.stderr)
        return 2

    def emit(line) -> None:
        print(json.dumps(line), flush=True)

    out = run(args.device or "cuda",
              n_sigs=int(os.environ.get("BENCH_N", "100000")),
              n_closes=int(os.environ.get("BENCH_CLOSES", "24")),
              close_txs=int(os.environ.get("BENCH_CLOSE_TXS", "1000")),
              dex_pct=int(os.environ.get("BENCH_DEX_PCT", "30")), emit=emit)
    emit(out["line"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
