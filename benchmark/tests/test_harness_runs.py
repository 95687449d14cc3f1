"""Each driver end to end on the CPU at a tiny size: the sound run is
correct, reports its cell's metrics and loads nothing of JAX; each fault
of the timed path, the control among them, makes it not correct."""
import pytest

from benchmark import harness
from benchmark.tests import tiny

CELLS = sorted(tiny.TINY)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(cell, trace):
    line = tiny.run(cell, trace=trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["forbidden"] == []
    assert list(line)[-2] == "checks"      # last in the printed line
    want = {m["name"] for m in harness.metrics_for(harness.benchmark(),
                                                   cell, trace)}
    # device metrics are left out on the CPU; every other one is there
    device = {m["name"] for m in harness.benchmark()["per_layer"]
              if m["source"] == "device_trace"}
    if cell == "tier1_net.pay_100":
        device |= {"tally.ms_per_ledger", "tally.calls_per_ledger"}
    assert want - device <= set(line["metrics"]) <= want
    if trace:
        assert line["device"]["window_s"] > 0
        assert "breakdown" in line


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["accept_all", "drop_half", "unchanged"])
def test_broken_step_is_not_correct(cell, fault):
    line = tiny.run(cell, fault=fault)
    assert not line["correct"], (fault, line["checks"])
    assert line["forbidden"] == []


def test_same_seed_same_traffic():
    from benchmark.traffic import Traffic

    a, b = (Traffic(2**33 + 5, "p", 6, 10**9, 50) for _ in range(2))
    wa = [e.wire for e in a.payments(range(6), [1] * 6, 1)]
    wb = [e.wire for e in b.payments(range(6), [1] * 6, 1)]
    assert wa == wb
    c = Traffic(2**33 + 6, "p", 6, 10**9, 50)
    assert [e.wire for e in c.payments(range(6), [1] * 6, 1)] != wa
