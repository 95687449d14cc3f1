"""The port's nine benchmark tools (``stellar_core_tpu_torch/tools/``) obey
the tools' rules: each exits non-zero with no GPU and no ``--device``,
before any work and with nothing on stdout; each imports only the port
(no ``jax``, no ``stellar_core_tpu``, no ``tests`` module); the shared
helpers give every backend arm its tiers, device, card and launches.

The tools' results are held against the repository's JAX tools in
``tests/test_torch_tools_*.py``, each run with ``--device cpu`` from the
test's own directory, which must stay empty without ``--out``.
"""
import ast
import importlib
import json
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("quorum_tier_bench", "multichip_bench", "parallel_apply_bench",
         "pipeline_bench", "soak_bench", "scp_forensics_bench",
         "fuzz_bench", "bucket_scale_bench", "read_bench")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_without_a_gpu_exits_non_zero(tool, monkeypatch, capsys,
                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"stellar_core_tpu_torch.tools.{tool}")
    assert mod.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("tool", TOOLS + ("_workloads", "contractor_probe"))
def test_tool_imports_only_the_port(tool):
    path = REPO / "stellar_core_tpu_torch" / "tools" / f"{tool}.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "stellar_core_tpu", "tests", "tools",
                "chip_smoke"), (tool, name)
    text = path.read_text()
    assert "cpu-fallback" not in text and "REPO" not in text


def test_backend_arms_and_their_rows(monkeypatch):
    from stellar_core_tpu_torch import tools
    from stellar_core_tpu_torch.ops import ed25519_cuda

    assert tools.BACKENDS["cuda"] == {
        "device": "cuda", "CRYPTO_BACKEND": "cuda",
        "SCP_TALLY_BACKEND": "tensor"}
    assert tools.BACKENDS["cpu"] == tools.node_kw("cpu")
    app = tools.standalone_app("cpu")
    assert (app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND,
            app.config.MANUAL_CLOSE) == ("cpu", "host", True)
    app.graceful_stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tools.arm("cpu") as row:
        launches = ed25519_cuda.launches
    assert ed25519_cuda.launches == launches
    assert row == {"backend": "cpu", "device": "cpu",
                   "CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host",
                   "card": None, tools.LAUNCHES: 0}


@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu"], ["cpu"]), ([], ["cuda", "cpu"]),
    (["--backend", "cpu"], ["cpu"]),
    (["--backend", "cpu", "--backend", "cuda"], ["cpu", "cuda"])])
def test_backends_follow_device_and_backend(argv, want):
    import argparse

    from stellar_core_tpu_torch import tools

    ap = argparse.ArgumentParser()
    tools.add_backend_arg(ap)
    assert tools.backends(ap, ap.parse_args(argv)) == want


def test_backends_take_turns():
    from stellar_core_tpu_torch import tools

    assert [tools.turns(["cuda", "cpu"], i) for i in range(4)] == [
        ["cuda", "cpu"], ["cpu", "cuda"], ["cuda", "cpu"], ["cpu", "cuda"]]
    assert tools.turns(["cpu"], 1) == ["cpu"]


def test_apply_grid_runs_each_arm_on_both_backends_in_turns(monkeypatch):
    """Every grid arm runs on the ``cuda`` and the ``cpu`` node back to
    back, the order alternating arm by arm, so the host's drift over the
    grid falls on both backends alike."""
    from stellar_core_tpu_torch.tools import parallel_apply_bench as PAB

    calls = []

    class Enough(Exception):
        pass

    def bench_workload(backend, shape, pattern, closes, close_txs, dex_pct,
                       workers, native, fee, pipelined):
        calls.append((backend, (shape, workers, native, fee, pipelined)))
        if len(calls) == 6:
            raise Enough

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(PAB, "bench_workload", bench_workload)
    with pytest.raises(Enough):
        PAB.main(["--shapes", "pay", "--no-parity"])
    arms = PAB.grid_arms(["pay"])[:3]
    assert calls == [("cuda", arms[0]), ("cpu", arms[0]),
                     ("cpu", arms[1]), ("cuda", arms[1]),
                     ("cuda", arms[2]), ("cpu", arms[2])]


def test_device_cpu_has_no_cuda_arm(capsys):
    import argparse

    from stellar_core_tpu_torch import tools

    ap = argparse.ArgumentParser()
    tools.add_backend_arg(ap)
    with pytest.raises(SystemExit) as exc:
        tools.backends(ap, ap.parse_args(["--device", "cpu", "--backend",
                                          "cuda"]))
    assert exc.value.code == 2
    assert "no cuda arm" in capsys.readouterr().err


def run_tool(tool: str, argv: list, tmp_path, capsys) -> tuple:
    """``tool``'s ``main(argv + ["--device", "cpu"])`` from ``tmp_path``:
    (exit code, every stdout line parsed, the files it left there)."""
    import os

    mod = importlib.import_module(f"stellar_core_tpu_torch.tools.{tool}")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc = mod.main(argv + ["--device", "cpu"])
    finally:
        os.chdir(cwd)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return rc, lines, sorted(p.name for p in tmp_path.iterdir())
