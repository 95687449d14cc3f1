"""The benchmark finds every piece by its name, a piece added only as new
files is picked up, and BENCHMARK.json keeps to the contract's shapes."""
import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_API = ("setup", "window_open", "prepare", "step", "after",
              "window_close", "collect", "judge")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(entry):
    wl = harness.workload(entry["name"])
    assert wl["name"] == entry["name"]
    assert harness.config(entry["config"])["name"] == entry["config"]
    drv = harness.driver(wl["driver"])
    assert all(callable(getattr(drv, f)) for f in DRIVER_API)
    e2e = harness.metrics_for(BENCH, entry["name"], False)
    layer = harness.metrics_for(BENCH, entry["name"], True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer and {m["moves"] for m in layer} <= {m["name"] for m in e2e}
    assert entry["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]]
                         + [m["name"] for m in BENCH["end_to_end"]
                            if m["name"] != "setup_s"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"]
        assert all(k in cfg for k in cfg["reduced"])
    assert BENCH["paths"] == ["benchmark"]
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) // (
        BENCH["run_seconds"] + 60)


def test_new_cell_and_metric_from_new_files_only(tmp_path):
    """A scratch copy gains a cell (a workload file on an existing driver)
    and a per-layer metric (a reader file) and entries in its
    BENCHMARK.json; no file of the benchmark is edited, and a run of the
    new cell reports the new metric."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    wl = harness.workload("standalone.flooded_1k")
    wl.update(name="standalone.flooded_24", per_ledger=24)
    (tmp_path / "benchmark/workloads/standalone.flooded_24.json").write_text(
        json.dumps(wl))
    (tmp_path / "benchmark/metrics/admit.envelopes_per_ledger.py").write_text(
        "def read(ctx):\n"
        "    return ctx.attempted / len(ctx.steps) if ctx.steps else None\n")
    bench["workloads"].append({
        "name": "standalone.flooded_24", "config": "standalone",
        "traffic": "flooded_24", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "standalone.flooded_1k" in m.get("workloads", []):
            m["workloads"].append("standalone.flooded_24")
    bench["per_layer"].append({
        "name": "admit.envelopes_per_ledger", "unit": "envelopes",
        "better": "higher", "source": "host_clock",
        "layer": "herder admission", "moves": "ledger_ms",
        "workloads": ["standalone.flooded_24"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    overrides = {**tiny.TINY["standalone.flooded_1k"], "accounts": 30,
                 "per_ledger": 24}
    line = tiny.run("standalone.flooded_24", trace=True,
                    overrides=overrides, root=tmp_path)
    assert line["correct"], line["checks"]
    assert line["metrics"]["admit.envelopes_per_ledger"]["value"] == 24
