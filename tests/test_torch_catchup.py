"""The port's ``history/``, ``catchup/`` and ``work/`` held against the
reference: every case of ``tests/test_history_catchup.py`` and
``tests/test_catchup.py`` runs on the port, as the very code of those
files with the package's dotted name ``stellar_core_tpu.`` written
``stellar_core_tpu_torch.`` (the rule of the port's copies) and their
relative imports rebound to the port's versions of their helpers.

The port's ``Simulation`` puts every node on the GPU unless told
otherwise, so the executed modules' ``Simulation`` is pinned here, never
through a library default: ``device="cpu"`` with ``CRYPTO_BACKEND="cpu"``
and ``SCP_TALLY_BACKEND="host"`` for every node, unless a case names its
own.  ``make_node`` builds ``test_config`` nodes, which pin the host tiers
already.

Cases of its own: BASELINE config #4's replay path
(``chip_smoke.run_catchup``) at a small size, a complete-mode joiner on
``CRYPTO_BACKEND="cuda"`` with ``device="cpu"`` (the kernel's plain torch
version behind its wrapper) beside a ``cpu`` joiner and a minimal one,
over a range where two ledgers carry signatures; and the port's
``tools.catchup_bench`` on the CPU, and its exit without a GPU.

Held against the JAX package itself: ``test_catchup.py``'s archive
catchup and live cold join, minimal and complete, built by the same code
in both packages give byte-equal stored headers (so equal header and
bucket-list hashes) seq by seq, publisher and joiner alike.

Tolerance: exact (header hashes, bucket-list hashes, tx results, counts).
"""
import json
import os
import subprocess
import sys

import pytest

from chip_smoke import run_catchup

from .test_torch_golden import TESTS, HostSimulation, _port_tests, port_module


def _modules():
    hc = port_module("test_history_catchup")
    c = port_module("test_catchup")
    c.Simulation = HostSimulation
    return hc, c


_HC, _C = _modules()
globals().update(_port_tests(_HC))
globals().update(_port_tests(_C))


def test_cases_run_on_the_port():
    """Every test of both JAX files is here, and each runs the port."""
    for mod, path in ((_HC, "test_history_catchup.py"),
                      (_C, "test_catchup.py")):
        names = set(_port_tests(mod))
        assert names and names <= set(globals()), path
        text = (TESTS / path).read_text()
        assert names == {n for n in names if f"def {n}(" in text
                         or f"class {n}" in text}
        assert text.count("\ndef test_") + text.count("\nclass Test") == \
            len(names)
    assert _C.CatchupWork.__module__ == \
        "stellar_core_tpu_torch.catchup.catchup_work"
    assert _HC.Application.__module__ == \
        "stellar_core_tpu_torch.main.application"
    assert _C.Simulation is HostSimulation


def test_pinned_simulation_nodes_run_the_host_tiers():
    sim = HostSimulation()
    app = sim.add_node(b"\x01" * 32, {"threshold": 1, "validators": []})
    assert (app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND) == \
        ("cpu", "host")
    app = sim.add_node(b"\x02" * 32, {"threshold": 1, "validators": []},
                       CRYPTO_BACKEND="cuda")
    assert app.config.CRYPTO_BACKEND == "cuda"
    assert app.device.type == "cpu"


def _header_rows(app) -> list:
    """Every (seq, header XDR) row a node stored: equal rows are equal
    header hashes and bucket-list hashes, seq by seq."""
    return app.database.execute(
        "SELECT ledgerseq, data FROM ledgerheaders "
        "ORDER BY ledgerseq").fetchall()


def _archive_catchup(mod, d, mode):
    """``test_catchup.py``'s published archive (20 ledgers, checkpoints 7
    and 15) and a fresh ``make_node`` caught up to checkpoint 15 in
    ``mode`` by ``CatchupWork``: (publisher, joiner)."""
    pub, arch_dir, cp = mod._published_archive(d)
    app = mod.make_node(d, name="joiner", archive_dir=arch_dir)
    work = mod.CatchupWork(app, app.history_manager.archives[0],
                           mod.CatchupConfiguration(cp, mode))
    assert mod._run_catchup(app, work) == mod.State.SUCCESS
    assert app.ledger_manager.last_closed_seq() == cp == 15
    return pub, app


def _live_catchup(mod, d, mode):
    """``test_catchup.py``'s cold join of a live core-2 network (18
    ledgers before the join, 14 during it): (validator A, joiner)."""
    kw = {"CATCHUP_COMPLETE": True} if mode == "complete" else {}
    sim, joiner, app_a, jid, ids = mod._cold_join_scenario(d, joiner_kw=kw)
    return app_a, joiner


@pytest.mark.parametrize("mode", ["minimal", "complete"])
@pytest.mark.parametrize("path", ["archive", "live"])
def test_catchup_equals_the_jax_package(tmp_path, path, mode, monkeypatch):
    """The same publisher and cold joiner built by the very code of
    ``tests/test_catchup.py`` in the JAX package and in the port: the
    publisher's and the joiner's stored headers are byte-equal across the
    two packages at every seq, and so are the joiner's last hash, its
    bucket-list hash and what its catchup did (buckets applied, ledgers
    replayed)."""
    from stellar_core_tpu.utils import device as jax_device

    from . import test_catchup as J

    # the JAX nodes resolve ``auto`` to their host tiers, with no probe
    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    build = _archive_catchup if path == "archive" else _live_catchup
    runs = {}
    for name, mod, pkg in (("jax", J, "stellar_core_tpu"),
                           ("port", _C, "stellar_core_tpu_torch")):
        d = tmp_path / name
        d.mkdir()
        pub, joiner = build(mod, d, mode)
        assert type(joiner).__module__ == pkg + ".main.application"
        count = joiner.metrics.counter
        runs[name] = {
            "publisher": _header_rows(pub), "joiner": _header_rows(joiner),
            "lcl": joiner.ledger_manager.last_closed_hash(),
            "bucket_list": joiner.bucket_manager.get_bucket_list_hash(),
            "applied": count("catchup.bucket.applied-entries").count,
            "replayed": count("catchup.ledger.replayed").count}
    jax, port = runs["jax"], runs["port"]
    assert port == jax
    assert (port["applied"] > 0) == (mode == "minimal")
    assert (port["replayed"] > 0) == (mode == "complete")
    joined = dict(port["joiner"])
    assert joined and set(joined) <= set(dict(port["publisher"]))
    assert all(dict(port["publisher"])[s] == row
               for s, row in joined.items())


def test_replay_on_the_batch_path_equals_the_cpu_joiner(tmp_path,
                                                       monkeypatch):
    """Config #4's replay at a small size: the publisher creates 8
    accounts in ledger 2 (one signature) and closes a peer's set of 8
    payments with one forged signature as ledger 3, then empty ledgers up
    to checkpoint 15.  Joiner A (complete, ``cuda`` backend on
    ``device="cpu"``) sends each of the 2 replayed ledgers with signatures
    through the wrapper once, padded to 256 rows; joiners B (complete,
    ``cpu``) and C (minimal to seq 9: buckets at 7, then 2 ledgers
    replayed) equal the publisher at every seq they share; A's and B's
    results for the forged ledger are equal, with one ``txBAD_AUTH``."""
    from stellar_core_tpu_torch.ops import ed25519_cuda

    calls = []
    real = ed25519_cuda.verify_batch

    def verify_batch(pk, sg, mg, *args):
        calls.append((int(pk.shape[0]), pk.device.type))
        return real(pk, sg, mg, *args)

    monkeypatch.setattr(ed25519_cuda, "verify_batch", verify_batch)
    launches0 = ed25519_cuda.launches
    run = run_catchup("cpu", str(tmp_path), n_accounts=8,
                      payment_ledgers=0, forge_every=8, checkpoints=2,
                      minimal_to=9)
    assert ed25519_cuda.launches == launches0   # the plain version
    pub = run["publisher"]
    assert pub["lcl"] == 15 and pub["signed_ledgers"] == [2, 3]
    a, b, c = (run["joiners"][k] for k in ("A", "B", "C"))
    assert (a["mode"], a["backend"], b["backend"], c["mode"]) == \
        ("complete", "cuda", "cpu", "minimal")
    assert a["replayed"] == b["replayed"] == 14 and c["replayed"] == 2
    assert a["batches"] == [[256]] * 2 and a["host_verifies"] == 0
    assert calls == [(256, "cpu")] * 2
    assert b["batches"] == [[]] * 2 and b["host_verifies"] == 1 + 8
    assert b["verify_cache_hits_misses"] == [0, 1 + 8]
    assert c["batches"] == [] and c["lcl"] == 9
    assert c["replayed_seqs"] == [8, 9]
    assert a["forged_results"] == b["forged_results"]
    assert a["forged_results"].count("txBAD_AUTH") == 1
    assert all(j["equal_to_publisher"] for j in (a, b, c))


def test_catchup_bench_tool_on_the_cpu(tmp_path):
    """The port's ``catchup_bench`` at a small tier on ``--device cpu``
    with ``cpu`` joiners: a minimal joiner applies buckets, a complete one
    replays, both end bit-identical to the validators; the result is the
    last line and, with ``--out``, the file."""
    out = tmp_path / "catchup.json"
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.catchup_bench",
         "--smoke", "--entries", "4000", "--per-close", "200",
         "--joiner-backend", "cpu", "--device", "cpu", "--out", str(out)],
        cwd=TESTS.parent, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()]
    assert [x.get("phase") for x in lines] == \
        ["seed", "minimal", "complete", None]
    result = lines[-1]
    assert result == json.loads(out.read_text())
    assert result["joiner_backend"] == "cpu" and result["tier"] == "smoke"
    assert result["gates_checked"] is False
    assert result["minimal"]["bucket_applied_entries"] > 0
    assert result["complete"]["ledgers_replayed"] > 0
    assert result["minimal"]["bit_identical"] and \
        result["complete"]["bit_identical"]
    assert result["complete"]["kernel_launches"] == 0


def test_catchup_bench_on_the_cpu_has_no_cuda_joiner(capsys):
    """``--device cpu`` means the host tiers for every node, as in the
    other tools: a ``cuda`` joiner with it is refused before any work."""
    from stellar_core_tpu_torch.tools import catchup_bench

    with pytest.raises(SystemExit) as exc:
        catchup_bench.main(["--smoke", "--device", "cpu",
                            "--joiner-backend", "cuda"])
    assert exc.value.code == 2
    assert "--device cpu runs the host tiers" in capsys.readouterr().err


def test_catchup_bench_without_a_gpu_exits_non_zero():
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.tools.catchup_bench",
         "--smoke"], cwd=TESTS.parent, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and not res.stdout
    assert "no CUDA device" in res.stderr
