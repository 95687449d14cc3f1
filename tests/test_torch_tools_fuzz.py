"""The port's ``tools/fuzz_bench`` against the repository's
``tools/fuzz_bench.py`` on the CPU (every network on ``cpu`` / ``host``):
the known-bad schedule fails with the same class and failure fingerprint
in both packages, and the same with the crank profiler armed (as every
fleet run arms it); the slice-evaluation A/B and the tool's ``main``; and,
in the slow set, the whole known-bad proof (found, ddmin-minimized,
persisted, replayed) and the smoke campaign's per-schedule results at the
JAX tool's parameters.

Tolerance: exact (failure classes and fingerprints, minimized events,
verdict counts).
"""
import pytest

from stellar_core_tpu_torch.tools import fuzz_bench as FB

from .test_torch_tools import run_tool


@pytest.fixture
def jax_host_tiers(monkeypatch, tmp_path):
    """The JAX networks resolve ``auto`` to their host tiers, and put their
    slow-close traces (``traces`` in the cwd: the JAX executor takes no
    node settings) under the test's own directory."""
    from stellar_core_tpu.utils import device as jax_device

    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    monkeypatch.chdir(tmp_path)


def test_known_bad_run_equals_the_jax_package(tmp_path, jax_host_tiers):
    from stellar_core_tpu.simulation.fuzz import known_bad_schedule as jkb
    from stellar_core_tpu.simulation.fuzz import run_schedule as jrun
    from stellar_core_tpu_torch.simulation.fuzz import known_bad_schedule

    mine = FB.runner("cpu", str(tmp_path))(known_bad_schedule())
    theirs = jrun(jkb())
    assert not mine["ok"] and mine["failure_class"] == "fork"
    for key in ("schedule_id", "failure_class", "failure_fingerprint",
                "fingerprint", "novelty"):
        assert mine[key] == theirs[key], key


def test_crank_profiled_run_is_the_same_run_with_a_profile(tmp_path,
                                                           capsys):
    """The fleet runs' hook: the network a schedule builds arms its crank
    profiler, the run's result is the unprofiled run's, and the progress
    lines name the network's buckets."""
    from stellar_core_tpu_torch.simulation.fuzz import known_bad_schedule

    run = FB.runner("cpu", str(tmp_path))
    plain = run(known_bad_schedule())
    with FB.crank_profiled(0.05) as sims:
        profiled = run(known_bad_schedule())
    for key in ("schedule_id", "failure_class", "failure_fingerprint",
                "novelty"):
        assert profiled[key] == plain[key], key
    rep = sims[-1].crank_report()
    assert rep["cranks"] > 0 and rep["virtual_s"] > 0
    assert rep["buckets_s"]["consensus"] > 0
    assert "progress: {'buckets_s'" in capsys.readouterr().err


def test_slice_eval_ab_verdicts_equal_the_jax_tool():
    from tools.fuzz_bench import bench_slice_eval

    mine, theirs = FB.bench_slice_eval(4, 3, rounds=3), \
        bench_slice_eval(4, 3, rounds=3)
    for key in ("evaluations", "verdicts_agree"):
        assert mine[key] == theirs[key]
    for arm in ("vectorized", "scalar"):
        assert mine[arm]["verdicts"] == theirs[arm]["verdicts"]


def test_fuzz_tool_on_the_cpu(tmp_path, capsys):
    """``main`` with the networks' parts skipped: the host A/B only."""
    rc, lines, files = run_tool(
        "fuzz_bench", ["--smoke", "--skip-campaigns"], tmp_path, capsys)
    assert files == []
    run, doc = lines
    assert run == {k: run[k] for k in ("backend", "device", "card",
                                       "CRYPTO_BACKEND", "SCP_TALLY_BACKEND",
                                       "crypto.verify.kernel-launches")}
    assert doc["slice_eval_ab"]["50"]["verdicts_agree"] is True
    assert rc == (0 if doc["green"] else 1)


@pytest.mark.slow
def test_known_bad_proof_equals_the_jax_tool(tmp_path, jax_host_tiers):
    from tools.fuzz_bench import prove_known_bad

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mine = FB.prove_known_bad(str(tmp_path / "p"), 16,
                              FB.runner("cpu", str(tmp_path / "p")))
    theirs = prove_known_bad(str(tmp_path / "j"), 16)
    assert mine.pop("repro_file") == \
        theirs.pop("repro_path").rsplit("/", 1)[1]
    assert mine == theirs and mine["replay_reproduced"] is True


@pytest.mark.slow
def test_smoke_campaign_equals_the_jax_tools(tmp_path, jax_host_tiers):
    """The JAX tool's ``--smoke`` campaign (seed0 9000, 4 schedules of the
    smoke profile, minimize budget 16) in both packages, with no wall
    budget (a budget could stop the two at different schedules): the same
    schedules, results and failure classes."""
    from stellar_core_tpu.simulation.fuzz import FuzzCampaign as JCampaign
    from stellar_core_tpu_torch.simulation.fuzz import FuzzCampaign

    def results(cls, tag, **kw):
        camp = cls(seed0=9000, profile="smoke", schedules=4,
                   corpus_dir=str(tmp_path / tag / "corpus"),
                   traces_dir=str(tmp_path / tag), minimize_budget=16, **kw)
        summary = camp.run()
        return summary, [(r["schedule_id"], r["ok"], r["failure_class"],
                          r["fingerprint"]) for r in camp.results]

    mine, mine_rows = results(FuzzCampaign, "p",
                              run=FB.runner("cpu", str(tmp_path / "p")))
    theirs, their_rows = results(JCampaign, "j")
    assert mine_rows == their_rows and len(mine_rows) == 4
    for key in ("schedules_executed", "unique_novelty", "failure_count"):
        assert mine[key] == theirs[key], key
    assert [f["failure_class"] for f in mine["failures"]] == \
        [f["failure_class"] for f in theirs["failures"]]
