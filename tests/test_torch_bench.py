"""The port's headline bench, ``python -m stellar_core_tpu_torch.bench``, on
its CPU route (``--device cpu``: node A's batch and the verify stage run the
plain torch version) at a small size: 512 signatures and 2 closes of 50
transactions a shape.

- Its signature batch (the sha256 of its triples' bytes) equals what the
  JAX package's pieces give for the same sizes: ``LoadGenerator`` on a
  node seeded alike -> ``TxSetFrame.make_from_wire`` ->
  ``collect_signature_batch``.
- Every verdict is true; both nodes ended every close with one ledger hash
  (the bench raises otherwise); the last line has the JAX bench line's
  keys and the ``cpu`` node's close p50; the flight-recorder line is
  printed, and the bench writes no file.
- Without ``--device`` and without a GPU it exits non-zero.

Tolerance: exact (digests, counts).
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu.herder.tx_set import TxSetFrame as JTxSetFrame
from stellar_core_tpu.main import Application as JApplication
from stellar_core_tpu.main import test_config as j_test_config
from stellar_core_tpu.simulation.load_generator import \
    LoadGenerator as JLoadGenerator
from stellar_core_tpu.utils.clock import ClockMode as JClockMode
from stellar_core_tpu.utils.clock import VirtualClock as JVirtualClock
from stellar_core_tpu.xdr import types as JT

REPO = Path(__file__).resolve().parents[1]
SIZES = {"BENCH_N": "512", "BENCH_CLOSES": "2", "BENCH_CLOSE_TXS": "50"}
# the JAX bench line's keys (its best-capture record aside: the port's
# bench keeps no file)
JAX_LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "cpu_verifies_per_sec",
    "n_signatures", "kernel", "device", "ledger_close_p50_ms",
    "ledger_close_p99_ms", "ledger_close_max_ms", "close_samples",
    "close_txs", "close_shape", "ledger_close_p50_ms_payments",
    "apply_op_type_ms", "close_phase_ms", "bucket_merge_stats"}


def _bench(args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.bench", *args],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=str(REPO), **env),
        capture_output=True, text=True, timeout=600)


def _repo_files() -> dict:
    """(size, mtime) of the repository's top-level files and of the
    port's sources: where a bench that writes its records would write."""
    paths = [p for p in REPO.iterdir() if p.is_file()]
    paths += [p for p in (REPO / "stellar_core_tpu_torch").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts]
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns) for p in paths}


def _jax_triples_sha256(n_sigs: int, close_txs: int) -> str:
    """The JAX bench's config #2 batch for these sizes, from its pieces."""
    app = JApplication(JVirtualClock(JClockMode.VIRTUAL_TIME), j_test_config(
        UPGRADE_DESIRED_MAX_TX_SET_SIZE=max(100, close_txs),
        CRYPTO_BACKEND="cpu"))
    app.start()
    app.herder.manual_close()
    lg = JLoadGenerator(app)
    lg.create_accounts(min(n_sigs, 2000))
    tx_set = JTxSetFrame.make_from_wire(
        app.config.network_id(), JT.TransactionSet.make(
            previousLedgerHash=app.ledger_manager.last_closed_hash(),
            txs=lg.generate_payments(n_sigs)))
    triples, _ = tx_set.collect_signature_batch()
    n = len(triples)
    cols = [np.frombuffer(b"".join(t[k].ljust(w, b"\x00") for t in triples),
                          np.uint8).reshape(n, w)
            for k, w in ((0, 32), (1, 64), (2, 32))]
    return hashlib.sha256(b"".join(c.tobytes() for c in cols)).hexdigest()


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("bench")
    before = _repo_files()
    res = _bench(["--device", "cpu"], cwd, **SIZES)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    return {"lines": lines, "repo_unchanged": _repo_files() == before,
            "cwd_files": sorted(p.name for p in cwd.iterdir())}


def test_bench_batch_equals_the_jax_pieces(bench_run):
    config2 = bench_run["lines"][0]
    assert config2["phase"] == "config2"
    assert config2["n_signatures"] == 512 and config2["n_padded"] == 512
    assert config2["triples_sha256"] == _jax_triples_sha256(512, 50)


def test_bench_verdicts_closes_and_last_line(bench_run):
    config2, trace, line = bench_run["lines"]
    assert config2["verdicts_true"] == config2["n_padded"]
    assert config2["kernel"] == "plain" and config2["device"] == "cpu"
    assert trace["metric"] == "ledger_close_flight_recorder"
    assert trace["close_samples"] == 2 and trace["spans_per_close"] > 0
    assert JAX_LINE_KEYS <= set(line)
    assert line["metric"] == "ed25519_verifies_per_sec_txset"
    assert (line["n_signatures"], line["close_samples"],
            line["close_txs"]) == (512, 2, 50)
    assert line["close_ledger_hashes_equal"] is True
    for key in ("ledger_close_p50_ms", "ledger_close_p50_ms_cpu_backend",
                "value", "cpu_verifies_per_sec"):
        assert line[key] > 0, key
    assert line["vs_baseline"] == round(
        config2["rate"] / config2["cpu_verifies_per_sec"], 2)


def test_bench_writes_no_file(bench_run):
    assert bench_run["repo_unchanged"]
    assert bench_run["cwd_files"] == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_bench_without_a_gpu_exits_non_zero(tmp_path):
    res = _bench([], tmp_path, **SIZES)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert res.stdout == ""
