"""The port's operator surface held against the JAX package's: the admin
HTTP server, the XDR query language and the command line
(``python -m stellar_core_tpu_torch``).

- ``tests/test_xdrquery.py`` and the endpoint cases of
  ``tests/test_tracing.py`` (``trace``, ``trace-summary``, ``metrics`` as
  JSON and as Prometheus text) run on the port as the very code of those
  files with the package's dotted name ``stellar_core_tpu.`` written
  ``stellar_core_tpu_torch.``;
- ``version`` and ``self-check`` on a ``cpu``-backend TOML print what the
  JAX command line prints (``version``: but for the program's name);
- ``run`` with ``CRYPTO_BACKEND="auto"`` and no GPU exits non-zero with the
  port's "no CUDA device" error, and does not run on the CPU;
- ``tests/test_tcp_node.py`` on the port, and ``chip_smoke.run_cli`` on
  the ``cpu`` backend (slow, as the JAX test is): two node processes
  converge over TCP and take transactions through HTTP.

Tolerance: exact (JSON equality).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stellar_core_tpu_torch.crypto import SecretKey, sha256
from stellar_core_tpu_torch.crypto.strkey import (encode_ed25519_public_key,
                                                  encode_ed25519_seed)

from .test_torch_golden import _as_port_module, port_module

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
XDRQUERY_CASES = ("test_account_balance_filter", "test_union_arm_selects_type",
                  "test_boolean_operators", "test_bytes_vs_hex_literal",
                  "test_missing_path_fails_row", "test_not_and_parens",
                  "test_syntax_error")
TRACING_ENDPOINT_CASES = ("test_trace_endpoint_serves_chrome_json",
                          "test_trace_summary_endpoint",
                          "test_metrics_prometheus_exposition",
                          "test_metrics_default_json_is_unchanged")

_tracing = port_module("test_tracing")
slow_close = _tracing.slow_close   # the module-scoped fixture, on the port


@pytest.mark.parametrize("name", XDRQUERY_CASES)
def test_xdrquery_case_on_the_port(name):
    mod = _as_port_module("torch_xdrquery", TESTS / "test_xdrquery.py")
    assert mod.compile_query.__module__ == \
        "stellar_core_tpu_torch.utils.xdrquery"
    getattr(mod, name)()


@pytest.mark.parametrize("name", TRACING_ENDPOINT_CASES)
def test_tracing_endpoint_case_on_the_port(name, slow_close):
    assert _tracing.CommandHandler.__module__ == \
        "stellar_core_tpu_torch.main.http_server"
    getattr(_tracing, name)(slow_close)


def single_node_toml(path: Path, crypto_backend: str) -> Path:
    """A one-validator node's TOML (its own 1-of-1 quorum, in-memory
    database, traces under ``path``'s directory)."""
    seed = sha256(b"cli-node")
    me = encode_ed25519_public_key(SecretKey(seed).public_key().raw)
    path.write_text(f"""
network_passphrase = "cli test net"
node_seed = "{encode_ed25519_seed(seed)}"
run_standalone = true
manual_close = true
trace_dir = "{path.parent / 'traces'}"
crypto_backend = "{crypto_backend}"
scp_tally_backend = "host"

[quorum_set]
threshold = 1
validators = ["{me}"]
""")
    return path


def _cli(package: str, *args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", package, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _last_json(res) -> dict:
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_version_names_the_port(tmp_path):
    got = _last_json(_cli("stellar_core_tpu_torch", "version", cwd=tmp_path))
    want = _last_json(_cli("stellar_core_tpu", "version", cwd=tmp_path))
    assert got == dict(want, version="stellar-core-tpu-torch 0.3.0")


def test_self_check_on_a_cpu_toml_equals_jax(tmp_path):
    conf = single_node_toml(tmp_path / "node.toml", "cpu")
    args = ("--conf", str(conf), "self-check")
    got = _last_json(_cli("stellar_core_tpu_torch", *args, cwd=tmp_path))
    want = _last_json(_cli("stellar_core_tpu", *args, cwd=tmp_path))
    assert got == want and got["ok"] is True


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_metrics_reads_the_kernel_wrappers_launch_count(backend,
                                                         monkeypatch):
    """A ``cuda``-backend node's ``/metrics`` carries the verify kernel's
    own launch counter (``ops/ed25519_cuda.launches``, raised where the
    kernel launches) as the gauge ``crypto.verify.kernel-launches``, in
    JSON and in Prometheus text, read at each scrape; a ``cpu``-backend
    node has none."""
    from stellar_core_tpu_torch.main import Application
    from stellar_core_tpu_torch.main.config import test_config
    from stellar_core_tpu_torch.main.http_server import CommandHandler
    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock

    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                      test_config(CRYPTO_BACKEND=backend), device="cpu")
    app.start()
    handler = CommandHandler(app)
    name = "crypto.verify.kernel-launches"
    for n in (0, 7, 12):
        monkeypatch.setattr(ed25519_cuda, "launches", n)
        _, body = handler.metrics({})
        prom = handler.metrics({"format": "prometheus"})[1].data.decode()
        if backend == "cpu":
            assert name not in body["metrics"]
            assert "kernel_launches" not in prom
            continue
        assert body["metrics"][name] == {"type": "gauge", "value": n}
        assert f"crypto_verify_kernel_launches {n}\n" in prom


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_run_with_auto_and_no_gpu_exits_non_zero(tmp_path):
    conf = single_node_toml(tmp_path / "node.toml", "auto")
    res = _cli("stellar_core_tpu_torch", "--conf", str(conf), "run",
               cwd=tmp_path, timeout=60)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert '"starting"' not in res.stdout


@pytest.mark.slow
def test_chip_smoke_cli_run_on_the_cpu_backend():
    """``chip_smoke.run_cli`` (the ``cli`` phase) on the ``cpu`` backend: two
    node processes close ledgers past the traffic with one header hash and
    batch their overlay envelopes on the host (no device batches)."""
    from chip_smoke import run_cli

    out = run_cli("cpu")
    assert out["crypto_backend"] == ["cpu", "cpu"]
    assert out["quorum"]["intersection"] is True
    for m in out["metrics"]:
        assert m["overlay.sigbatch.batches"] > 0
        assert "crypto.verify.kernel-launches" not in m


@pytest.mark.slow
def test_two_processes_converge_and_accept_tx_on_the_port(tmp_path):
    port_module("test_tcp_node").test_two_processes_converge_and_accept_tx(
        tmp_path)
