"""The port's fuzzers held against the reference: ``fuzzing.py`` (a copy)
runs every case of ``tests/test_fuzz.py``, and ``simulation/fuzz/`` (the
schedule IR and executor as seams, the minimizer and campaign as copies)
every case of ``tests/test_fuzz_schedule.py`` (its slow cases stay slow),
each as the very code of that file with the package's dotted name
``stellar_core_tpu.`` written ``stellar_core_tpu_torch.``.

The executor builds its networks with the port's network constructors,
which put every node on the GPU unless told otherwise; so the executed
module's ``run_schedule``, ``minimize_schedule`` and ``verify_repro`` are
pinned here to ``device="cpu"`` with ``CRYPTO_BACKEND="cpu"`` and
``SCP_TALLY_BACKEND="host"`` (``functools.partial``), never through a
library default, and so is the executor in the subprocess of its slow
fingerprint case.

Held against the JAX package itself: ``generate_schedule`` gives the same
canonical bytes for every profile; both ``traces/FUZZ_REPRO_*.json``
reproduce on the port with their committed class and fingerprint; the
port's ``tools.fuzz_repro`` exits 0, 1 and 2 where the repository's
``tools/fuzz_repro.py`` does, and 3 with no GPU and no ``--device``.
The seams pass ``device`` and the node keywords through to every node.

Tolerance: exact (schedule bytes, failure classes and fingerprints, exit
codes).
"""
import functools
import json
import os
import subprocess
import sys

import pytest

from stellar_core_tpu_torch.simulation.fuzz import executor
from stellar_core_tpu_torch.simulation.fuzz import schedule as S
from stellar_core_tpu_torch.simulation.fuzz.minimize import (
    minimize_schedule, verify_repro)

from .test_torch_golden import TESTS, _as_port_module, _port_tests

REPO = TESTS.parent
NODE = {"device": "cpu", "CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}
run_schedule = functools.partial(executor.run_schedule, **NODE)
REPROS = sorted((REPO / "traces").glob("FUZZ_REPRO_*.json"))

_FUZZ = _as_port_module("torch_fuzz", TESTS / "test_fuzz.py")
_SCHED = _as_port_module(
    "torch_fuzz_schedule", TESTS / "test_fuzz_schedule.py",
    **{"r = run_schedule(kb)\\n":
       "r = run_schedule(kb, device='cpu', CRYPTO_BACKEND='cpu', "
       "SCP_TALLY_BACKEND='host')\\n"})
_SCHED.run_schedule = run_schedule
_SCHED.minimize_schedule = functools.partial(minimize_schedule,
                                             run=run_schedule)
_SCHED.verify_repro = functools.partial(verify_repro, run=run_schedule)
globals().update(_port_tests(_FUZZ))
globals().update(_port_tests(_SCHED))


@pytest.fixture(autouse=True)
def traces_in_tmp_path(tmp_path, monkeypatch):
    """A node's slow-close traces go to its ``TRACE_DIR``, ``traces`` in the
    cwd by default: every network this file builds (the executed cases'
    too) writes them under the test's own directory, never the checkout."""
    monkeypatch.chdir(tmp_path)


def test_cases_run_on_the_port():
    for mod, path in ((_FUZZ, "test_fuzz.py"),
                      (_SCHED, "test_fuzz_schedule.py")):
        names = set(_port_tests(mod))
        text = (TESTS / path).read_text()
        assert len(names) == text.count("\ndef test_") and \
            names <= set(globals()), path
    assert _FUZZ.TxFuzzer.__module__ == "stellar_core_tpu_torch.fuzzing"
    assert _SCHED.S is S


@pytest.mark.parametrize("profile", sorted(S.PROFILES))
def test_schedule_bytes_equal_the_jax_package(profile):
    from stellar_core_tpu.simulation.fuzz import schedule as JS

    assert sorted(S.PROFILES) == sorted(JS.PROFILES)
    for seed in (0, 1, 7, 99, 9002):
        mine = S.generate_schedule(seed, profile)
        theirs = JS.generate_schedule(seed, profile)
        assert S.canonical_bytes(mine) == JS.canonical_bytes(theirs)
        assert S.schedule_id(mine) == JS.schedule_id(theirs)
    assert S.canonical_bytes(S.known_bad_schedule()) == \
        JS.canonical_bytes(JS.known_bad_schedule())


@pytest.mark.parametrize("path", REPROS, ids=lambda p: p.name)
def test_committed_repro_reproduces_on_the_port(path):
    doc = S.load_schedule(str(path))
    verdict = verify_repro(doc, run=run_schedule)
    assert verdict["reproduced"], verdict
    assert verdict["got"] == doc["expect"]


@pytest.mark.parametrize("kind", ["core", "tiered"])
def test_topology_factory_passes_the_device_and_backends(kind):
    topo = {"kind": "core", "n": 4, "threshold": 2} if kind == "core" \
        else {"kind": "tiered", "n_orgs": 2, "per_org": 2}
    sim = S.topology_factory(topo, None, **NODE)()
    assert sim.device == "cpu" and len(sim.nodes) == 4
    for app in sim.nodes.values():
        assert (app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND,
                app.config.MANUAL_CLOSE) == ("cpu", "host", False)
    # a device backend on its own device
    sim = S.topology_factory(topo, None, device="cpu",
                             SCP_TALLY_BACKEND="both")()
    assert {app.herder.scp.tally_device.type
            for app in sim.nodes.values()} == {"cpu"}


def test_topology_factory_without_a_device_never_runs_quietly_on_the_cpu(
        monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make_sim = S.topology_factory({"kind": "core", "n": 4}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sim()


def test_run_schedule_passes_the_device_and_backends(monkeypatch):
    seen = []
    real = S.topology_factory

    def topology_factory(topo, persist_dir, device=None, **config_kw):
        seen.append(dict(config_kw, device=device))
        return real(topo, persist_dir, device=device, **config_kw)

    monkeypatch.setattr(S, "topology_factory", topology_factory)
    doc = S.load_schedule(str(REPROS[0]))
    res = run_schedule(doc["schedule"])
    assert seen == [NODE]
    assert res["failure_class"] == doc["expect"]["failure_class"]


def _tamper(path, tmp_path):
    doc = json.loads(path.read_text())
    doc["expect"]["failure_fingerprint"] = "0" * 64
    out = tmp_path / path.name
    out.write_text(json.dumps(doc))
    return out


def _corrupt(path, tmp_path):
    out = tmp_path / "corrupted.json"
    out.write_bytes(path.read_bytes()[:40])
    return out


@pytest.mark.parametrize("case,want", [("reproduced", 0), ("rotted", 1),
                                       ("invalid", 2)])
def test_fuzz_repro_exit_codes_equal_the_jax_tool(case, want, tmp_path):
    crash = next(p for p in REPROS if "crash" in p.name)
    path = {"reproduced": lambda: crash,
            "rotted": lambda: _tamper(crash, tmp_path),
            "invalid": lambda: _corrupt(crash, tmp_path)}[case]()
    # from the test's directory: the JAX tool's nodes put slow-close traces
    # in ``traces`` of the cwd
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    jax = subprocess.run([sys.executable, "-m", "tools.fuzz_repro",
                          str(path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    port = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.fuzz_repro",
         str(path), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert (jax.returncode, port.returncode) == (want, want), \
        (jax.stderr[-1000:], port.stderr[-1000:])
    if want != 2:
        line = json.loads(port.stdout)
        assert line["reproduced"] is (want == 0)
        assert line["got"]["failure_class"] == "crash:RuntimeError"


def test_fuzz_repro_without_a_gpu_exits_non_zero():
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.fuzz_repro",
         str(REPROS[0])], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 3 and not res.stdout
    assert "no CUDA device" in res.stderr
