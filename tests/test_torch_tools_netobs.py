"""The port's ``chaos_bench --netobs`` against the repository's
``tools/chaos_bench.py --netobs`` on the CPU: the core-4 observatory tier
at seed 11 (chaos and rate-mode load, flood tracing on, then off) on the
port's ``cpu`` arm (``device="cpu"``, host tiers) and in the JAX tool (its
host tiers: ``device_available`` patched to False) gives the same hashes
and meta digests, hop records, crank events by bucket, observatory
propagation percentiles (virtual time) and boolean gates.  The wall-clock
fields (bucket seconds, close p50, the overhead percentages) are not
compared.  Both tools' digests are read once every node's close tail
has landed (the port's tool drains them; the JAX tool's read races the
tail worker, so the test drains its nodes too).  Both run from the test's
own directory (the JAX tool's nodes
write slow-close traces into the cwd), which the port's tool leaves empty
without ``--out``.

Tolerance: exact (digests, counts, virtual-time percentiles, booleans).
"""
import pytest

from .test_torch_tools import run_tool

SEED = 11
GATES = ("hop_records_nonzero", "coverage_percentiles_present",
         "tracing_overhead_ok", "inert_hashes_and_meta", "attribution_ok")


@pytest.fixture(scope="module")
def jax_netobs(tmp_path_factory):
    import os

    from stellar_core_tpu.utils import device as jax_device

    from tools import chaos_bench as jax_bench

    d = tmp_path_factory.mktemp("jax-netobs")
    real, cwd = jax_device.device_available, os.getcwd()
    real_digests = jax_bench._run_digests

    def drained_digests(sim):
        # the JAX tool reads its digests while a pipelined node's last close
        # tail may still be emitting that ledger's meta (a race the port's
        # tool closes by draining): drain first, as the port does
        for app in sim.nodes.values():
            app.ledger_manager.pipeline.drain()
        return real_digests(sim)

    jax_device.device_available = lambda timeout=10.0: False
    jax_bench._run_digests = drained_digests
    os.chdir(d)
    try:
        doc = jax_bench.run_netobs(["core4"], SEED, str(d / "netobs.json"))
    finally:
        os.chdir(cwd)
        jax_device.device_available = real
        jax_bench._run_digests = real_digests
    return doc["tiers"]["core4"]


def test_core4_netobs_equals_the_jax_tool(jax_netobs, tmp_path, capsys):
    rc, lines, files = run_tool("chaos_bench", ["--netobs", "--tier",
                                                "core4"], tmp_path, capsys)
    assert rc == 0 and files == []
    on_row, off_row, gates_line, last = lines
    assert last["tiers"]["core4"]["cpu"] == gates_line["gates"]
    want = jax_netobs
    for row, mode in ((on_row, "on"), (off_row, "off")):
        assert (row["backend"], row["trace_enabled"]) == ("cpu",
                                                          mode == "on")
        assert row["crypto.verify.kernel-launches"] == 0
        assert row["overlay_launched_batches"] == 0
        assert row["overlay_batches"] > 0 and row["overlay_triples"] > 0
        assert row["digests"] == want[mode]["digests"]
        crank = want[mode]["crank_attribution"]
        assert row["events"] == crank["events"]
        assert sorted(row["buckets_s"]) == sorted(crank["buckets_s"])
    assert on_row["hop_records_total"] == want["on"]["hop_records_total"] > 0
    assert off_row["hop_records_total"] == 0
    for key in GATES:
        assert gates_line["gates"][key] == want["gates"][key] is True, key


def test_netobs_run_equals_the_jax_run_in_virtual_time(jax_netobs):
    """``netobs_run`` itself: the observatory's propagation percentiles
    (virtual seconds), flood volume, closes and loadgen ticks."""
    from stellar_core_tpu_torch.tools import BACKENDS
    from stellar_core_tpu_torch.tools.chaos_bench import netobs_run

    got = netobs_run("core4", SEED, True, **BACKENDS["cpu"])
    want = jax_netobs["on"]
    assert got["observatory"]["propagation"] == \
        want["observatory"]["propagation"]
    assert got["observatory"]["propagation"]["time_to_90pct"] is not None
    for key in ("hop_records_total", "flood_events_total", "closes_total",
                "loadgen", "digests", "n_nodes"):
        assert got[key] == want[key], key
    assert got["crank_attribution"]["events"] == \
        want["crank_attribution"]["events"]
    assert got["crank_attribution"]["cranks"] == \
        want["crank_attribution"]["cranks"]


def test_digests_wait_for_the_close_tails(jax_netobs, monkeypatch):
    """A pipelined node emits a ledger's meta on its close-tail worker.
    With every tail held back 20 ms, the digests still cover every
    ledger's meta: ``netobs_run`` drains the tails before reading them."""
    import threading
    import time

    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.tools import BACKENDS
    from stellar_core_tpu_torch.tools.chaos_bench import netobs_run

    real = Application.emit_ledger_close_meta
    late = []

    def emit(app, *args):
        if threading.current_thread() is not threading.main_thread():
            late.append(1)
            time.sleep(0.02)
        return real(app, *args)

    monkeypatch.setattr(Application, "emit_ledger_close_meta", emit)
    got = netobs_run("core4", SEED, False, **BACKENDS["cpu"])
    assert late and got["digests"] == jax_netobs["off"]["digests"]


def test_gates_are_the_jax_tools_formulae():
    """``netobs_gates`` on made-up runs: the same numbers the repository's
    ``run_netobs`` computes inline (disabled cost over the off run's flood
    volume per close, the enabled on/off delta, the 90% attribution)."""
    from stellar_core_tpu_torch.tools.chaos_bench import netobs_gates

    def run(p50, hops, attributed, digests):
        return {"close_p50_wall_s": p50, "hop_records_total": hops,
                "flood_events_total": 500, "closes_total": 10,
                "digests": digests,
                "observatory": {"propagation": {"time_to_90pct": {"p90": 1}}},
                "crank_attribution": {"attributed_pct": attributed}}

    g = netobs_gates(run(0.011, 7, 95.0, {"h": 1}),
                     run(0.010, 0, 96.0, {"h": 1}), 2e-8)
    assert g["stamp_sites_per_close"] == 100.0
    assert g["tracing_overhead_pct"] == round(2e-8 * 100 / 0.010 * 100, 4)
    assert g["enabled_overhead_pct"] == 10.0
    assert all(g[k] for k in GATES)
    g = netobs_gates(run(0.011, 0, 89.9, {"h": 1}),
                     run(0.010, 0, 96.0, {"h": 2}), 1e-3)
    assert not any(g[k] for k in GATES if k != "coverage_percentiles_present")


def test_backend_arm_picks_the_netobs_arms_only(tmp_path, capsys):
    """``--backend`` names the arms of ``--netobs``; a scenario run refuses
    it, and ``--device cpu`` has no ``cuda`` arm."""
    from stellar_core_tpu_torch.tools import chaos_bench

    with pytest.raises(SystemExit) as exc:
        chaos_bench.main(["--backend", "cpu", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--backend picks the arms of --netobs" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        chaos_bench.main(["--netobs", "--backend", "cuda", "--device",
                          "cpu"])
    assert not list(tmp_path.iterdir())
