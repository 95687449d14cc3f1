"""The port's ``tools/scp_forensics_bench`` against the repository's
``tools/scp_forensics_bench.py`` on the CPU: the induced-fork probe at
seed 14 forks a ``cpu`` / ``host`` core-4 network, attributes the fork to
the Byzantine node, reproduces its dump byte for byte on a rerun, and the
dump equals the JAX package's for the same seed (and the committed
``FORENSICS_induced_fork_seed14.json``); the recorder A/B runs through
the tool's ``main``.

Tolerance: exact (sha256 of the dump, attribution).
"""
import hashlib
from pathlib import Path

from .test_torch_tools import run_tool

REPO = Path(__file__).resolve().parents[1]
SEED, DURATION = 14, 6.0


def test_fork_probe_dump_equals_the_jax_package(tmp_path, capsys,
                                                monkeypatch):
    from stellar_core_tpu.simulation.chaos import run_induced_fork
    from stellar_core_tpu.simulation.simulation import core
    from stellar_core_tpu.utils import device as jax_device

    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    rc, lines, files = run_tool(
        "scp_forensics_bench", ["--smoke", "--closes", "2", "--txs", "20",
                                "--fork-seed", str(SEED),
                                "--fork-duration", str(DURATION)],
        tmp_path, capsys)
    assert files == []
    overhead, probe, doc = lines
    assert rc == (0 if doc["ok"] else 1)
    assert overhead["measurement"] == "overhead" and \
        overhead["closes_total"] == 4 and overhead["events_recorded"] > 0
    assert probe["attributed_to_byzantine"] is True
    assert probe["rerun_dump_identical"] is True
    assert probe["first_divergence"]["via"] == "equivocation"

    # the JAX tool's probe network (``core(4, threshold=2)``), host tiers,
    # from the test's directory: its nodes' slow-close traces go to the cwd
    d = tmp_path / "jax"
    monkeypatch.chdir(tmp_path)
    rep, path = run_induced_fork(
        lambda: core(4, threshold=2, persist_dir=str(d), MANUAL_CLOSE=False),
        seed=SEED, duration=DURATION, forensics_dir=str(d))
    want = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    assert probe["dump_sha256"] == want
    assert probe["dump"] == Path(path).name
    assert want == hashlib.sha256(
        (REPO / "FORENSICS_induced_fork_seed14.json").read_bytes()
    ).hexdigest()
    assert probe["divergence_slot"] == rep["divergence"]["slot"]
