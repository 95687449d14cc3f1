"""The port's boundary: it imports neither ``jax`` nor the JAX package, its
kernel wrapper never answers a GPU request with CPU verdicts, and
``chip_smoke.py`` fails (and prints no result) where there is no GPU or
no port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "stellar_core_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 12
    # importing ``__main__`` runs the command line: its ``version``
    prog = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    if m.endswith('.__main__'):\n"
            "        sys.argv = [m, 'version']\n"
            "        try:\n"
            "            __import__(m)\n"
            "        except SystemExit as e:\n"
            "            assert e.code == 0, e.code\n"
            "    else:\n"
            "        __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'stellar_core_tpu' or "
            "m.startswith('stellar_core_tpu.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", prog], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("route", ["plain_verify", "admission_step"])
def test_cpu_routes_run_on_one_thread_and_restore_the_callers_count(
        route, monkeypatch):
    """The port's CPU policy (``utils.device.cpu_threads``): a CPU tensor
    route runs on one intra-op thread, re-entrantly, and gives the
    caller's thread count back; a non-CPU device is left alone."""
    import torch

    from stellar_core_tpu_torch.models import admission
    from stellar_core_tpu_torch.ops import ed25519_kernel
    from stellar_core_tpu_torch.utils.device import cpu_threads

    seen = []
    if route == "plain_verify":
        real = ed25519_kernel._verify_impl
        monkeypatch.setattr(ed25519_kernel, "_verify_impl", lambda *a: (
            seen.append(torch.get_num_threads()), real(*a))[1])
    else:
        real = admission.Q.federated_ratify
        monkeypatch.setattr(admission.Q, "federated_ratify", lambda *a: (
            seen.append(torch.get_num_threads()), real(*a))[1])
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(3)
        (batch,) = admission.example_batch(n_sigs=4, n_nodes=4,
                                           device="cpu")
        sig_ok, _, _ = admission.admission_step(batch)
        assert bool(sig_ok.all())
        assert seen == [1] and torch.get_num_threads() == 3
        with cpu_threads(torch.device("cuda")):
            assert torch.get_num_threads() == 3
        with cpu_threads("cpu"):
            with cpu_threads("cpu"):
                assert torch.get_num_threads() == 1
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_name_neither_jax_nor_the_jax_package(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        # nor the repository's tests and JAX tools
        assert root not in ("jax", "jaxlib", "stellar_core_tpu", "tests",
                            "tools"), name
    assert "stellar_core_tpu." not in path.read_text()


def test_the_sweep_covers_every_tool():
    tools = {m for m in _port_modules()
             if m.startswith("stellar_core_tpu_torch.tools.")}
    assert tools >= {f"stellar_core_tpu_torch.tools.{t}" for t in (
        "catchup_bench", "chaos_bench", "fuzz_repro", "quorum_tier_bench",
        "multichip_bench", "parallel_apply_bench", "pipeline_bench",
        "soak_bench", "scp_forensics_bench", "fuzz_bench",
        "bucket_scale_bench", "read_bench", "_workloads",
        "contractor_probe", "trace_view", "fleet_scrape", "verify_green",
        "capture_loop", "lint", "lint.__main__", "lint.engine",
        "lint.determinism", "lint.locks", "lint.callgraph", "lint.interproc",
        "lint.concurrency", "lint.threadmodel", "lint.native", "lint.cache",
        "lint.safety")}


def test_kernel_wrapper_raises_for_default_device_inputs_without_gpu():
    from stellar_core_tpu_torch.ops import ed25519_cuda

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    pk = np.zeros((4, 32), np.uint8)
    sg = np.zeros((4, 64), np.uint8)
    before = ed25519_cuda.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519_cuda.verify_batch(pk, sg, pk)
    assert ed25519_cuda.launches == before


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: chip_smoke.py would run for real")
    res = _run_smoke(REPO)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
