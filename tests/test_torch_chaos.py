"""The port's chaos engine (``simulation/chaos.py``, a copy) held against
the reference: every case of ``tests/test_chaos.py`` runs on the port, as
the very code of that file with the package's dotted name
``stellar_core_tpu.`` written ``stellar_core_tpu_torch.`` (its slow cases
stay slow).  The port's network constructors put every node on the GPU
unless told otherwise, so the executed module's ``core`` and
``hierarchical_quorum`` are pinned here, never through a library
default: ``device="cpu"`` with ``CRYPTO_BACKEND="cpu"`` and
``SCP_TALLY_BACKEND="host"``.

Held against the JAX package itself: ``chaos_bench``'s core-4 tier
(pipelined close, seed 11) gives the same fingerprint (one hash over every
honest node's externalize sequence), externalize maps and fault counters
in both packages for ``chip_smoke.py``'s chaos scenarios
(``partition_heal``, ``flaky_links``, ``equivocator``), and the
fingerprints that its ``chaos`` phase holds the card to are the JAX
package's.  That phase's run (``chip_smoke.run_chaos``) on ``both``
tallies with a forged envelope in every node's inbox gives the same
fingerprint, every forged envelope refused.  The port's ``chaos_bench``
runs a scenario and its rerun, and exits non-zero with no GPU and no
``--device``.

Tolerance: exact (fingerprints, counters).
"""
import functools
import json
import os
import subprocess
import sys

import pytest

from chip_smoke import CHAOS_FINGERPRINTS, CHAOS_SCENARIOS, run_chaos
from stellar_core_tpu_torch.simulation import simulation as port_sim
from stellar_core_tpu_torch.simulation.chaos import run_standard_scenario

from .test_torch_golden import TESTS, _as_port_module, _port_tests

REPO = TESTS.parent
HOST = {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}
core = functools.partial(port_sim.core, device="cpu", **HOST)
hierarchical_quorum = functools.partial(port_sim.hierarchical_quorum,
                                        device="cpu", **HOST)

_CH = _as_port_module("torch_chaos", TESTS / "test_chaos.py")
_CH.core, _CH.hierarchical_quorum = core, hierarchical_quorum
globals().update(_port_tests(_CH))


@pytest.fixture(autouse=True)
def traces_in_tmp_path(tmp_path, monkeypatch):
    """A node's slow-close traces go to its ``TRACE_DIR``, ``traces`` in the
    cwd by default: every network this file builds (the executed cases'
    too) writes them under the test's own directory, never the checkout."""
    monkeypatch.chdir(tmp_path)


def test_cases_run_on_the_port():
    names = set(_port_tests(_CH))
    text = (TESTS / "test_chaos.py").read_text()
    assert len(names) == text.count("\ndef test_") and \
        names <= set(globals())
    assert _CH.ChaosEngine.__module__ == \
        "stellar_core_tpu_torch.simulation.chaos"
    sim = _CH.core(2)
    assert sim.device == "cpu"
    assert all((app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND) ==
               ("cpu", "host") for app in sim.nodes.values())


def _core4(d, **kw):
    """``chaos_bench``'s core-4 tier."""
    return dict(persist_dir=str(d), MANUAL_CLOSE=False, PIPELINED_CLOSE=True,
                **kw)


@pytest.mark.parametrize("scenario", CHAOS_SCENARIOS)
def test_core4_fingerprint_equals_the_jax_package(tmp_path, scenario,
                                                  monkeypatch):
    import stellar_core_tpu.simulation as J
    from stellar_core_tpu.simulation.chaos import \
        run_standard_scenario as jax_run
    from stellar_core_tpu.utils import device as jax_device

    # the JAX nodes resolve ``auto`` to their host tiers, with no probe
    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    port = run_standard_scenario(
        lambda: core(4, **_core4(tmp_path / "port")), scenario, seed=11,
        n_nodes=4, duration=18.0, forensics_dir=str(tmp_path))
    jax = jax_run(
        lambda: J.core(4, **_core4(tmp_path / "jax")), scenario, seed=11,
        n_nodes=4, duration=18.0, forensics_dir=str(tmp_path))
    assert port["fork_check"] == jax["fork_check"] == "pass"
    for key in ("fingerprint", "counters", "ledgers_closed",
                "per_node_externalized"):
        assert port[key] == jax[key], key
    assert port["fingerprint"] == CHAOS_FINGERPRINTS[scenario]


@pytest.mark.slow
def test_tiered50_fingerprint_equals_the_jax_package(tmp_path, monkeypatch):
    """``chaos_bench --tier tiered50 --scenario partition_heal`` (50
    validators, 10 orgs of 5) in both packages: the same fingerprint."""
    import stellar_core_tpu.simulation as J
    from stellar_core_tpu.simulation.chaos import \
        run_standard_scenario as jax_run
    from stellar_core_tpu.utils import device as jax_device

    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    kw = dict(MANUAL_CLOSE=False)
    port = run_standard_scenario(
        lambda: hierarchical_quorum(10, 5, persist_dir=str(tmp_path / "p"),
                                    **kw),
        "partition_heal", seed=11, n_nodes=50, duration=12.0,
        forensics_dir=str(tmp_path))
    jax = jax_run(
        lambda: J.hierarchical_quorum(10, 5, persist_dir=str(tmp_path / "j"),
                                      **kw),
        "partition_heal", seed=11, n_nodes=50, duration=12.0,
        forensics_dir=str(tmp_path))
    assert port["fingerprint"] == jax["fingerprint"]
    assert port["counters"] == jax["counters"]


@pytest.mark.parametrize("scenario", CHAOS_SCENARIOS)
def test_chip_smoke_chaos_run_refuses_forged_envelopes(scenario):
    rep = run_chaos(scenario, "cpu", True, CRYPTO_BACKEND="cpu",
                    SCP_TALLY_BACKEND="both")
    assert rep["fingerprint"] == CHAOS_FINGERPRINTS[scenario]
    assert rep["forged_refused"] == 4 and rep["tally_calls"] > 0
    assert rep["overlay_batches"] > 0 and rep["overlay_launches"] == 0


def test_chaos_bench_tool_on_the_cpu(tmp_path):
    out = tmp_path / "chaos.json"
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.chaos_bench",
         "--tier", "core4", "--scenario", "partition_heal", "--device",
         "cpu", "--out", str(out), "--forensics-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert lines[0]["tier"] == "core4" and lines[0]["rerun_identical"]
    assert lines[0]["fork_check"] == "pass" and \
        lines[0]["CRYPTO_BACKEND"] == "cpu"
    assert lines[-1]["scenarios"] == 1
    doc = json.loads(out.read_text())
    assert doc["scenarios"][0]["fingerprint"] == lines[0]["fingerprint"]


def test_chaos_bench_without_a_gpu_exits_non_zero():
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.chaos_bench",
         "--tier", "core4"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and not res.stdout
    assert "no CUDA device" in res.stderr
