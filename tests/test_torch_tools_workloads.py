"""The port's carried workloads (``stellar_core_tpu_torch/tools/
_workloads.py``) against the JAX tests' originals they copy, and the
parity passes of the port's ``pipeline_bench`` and ``soak_bench``
against the repository's ``tools/pipeline_bench.py`` and
``tools/soak_bench.py``, on the CPU (``cpu`` / ``host`` nodes); then each
tool at a tiny size through its ``main``.

Tolerance: exact (per-close ledger hash, bucket-list hash, meta bytes).
"""
import pytest

from stellar_core_tpu_torch.tools import _workloads

from .test_torch_tools import run_tool

CASES = {
    # the arguments of pipeline_bench's and soak_bench's parity passes
    "pipeline_on": ("run_workload", (True,),
                    {"eager": False, "PARALLEL_APPLY_WORKERS": 2}),
    "pipeline_off": ("run_workload", (False,),
                     {"PARALLEL_APPLY_WORKERS": 2}),
    "pipeline_no_dex": ("run_workload", (False,), {"dex": False}),
    "telemetry_on": ("run_telemetry_workload", (True,),
                     {"pipelined": True}),
    "telemetry_off": ("run_telemetry_workload", (False,),
                      {"pipelined": True}),
    "telemetry_sequential": ("run_telemetry_workload", (True,), {}),
}


def _rows(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("case", sorted(CASES))
def test_carried_workload_equals_the_jax_original(case):
    from tests.test_pipelined_close import run_workload
    from tests.test_txtrace import run_telemetry_workload

    name, args, kw = CASES[case]
    theirs = {"run_workload": run_workload,
              "run_telemetry_workload": run_telemetry_workload}[name]
    mine = _rows(getattr(_workloads, name)(*args, **kw))
    want = _rows(theirs(*args, **kw))
    assert len(mine) == len(want) == 6
    for i, (got, exp) in enumerate(zip(mine, want)):
        assert got[0] == exp[0], f"ledger hash @ {i}"
        assert got[1] == exp[1], f"bucket hash @ {i}"
        assert got[2] == exp[2], f"meta bytes @ {i}"
    assert _workloads.identical(mine, want)


@pytest.mark.parametrize("tool", ["pipeline_bench", "soak_bench"])
def test_parity_pass_equals_the_jax_tool(tool):
    import importlib

    port = importlib.import_module(f"stellar_core_tpu_torch.tools.{tool}")
    jax = importlib.import_module(f"tools.{tool}")
    if tool == "pipeline_bench":
        mine, theirs = port.parity_pass("cpu", 2), jax.parity_pass(1000, 30,
                                                                   2)
    else:
        mine, theirs = port.parity_pass("cpu"), jax.parity_pass()
    assert {k: mine[k] for k in theirs} == theirs
    assert theirs["hashes_identical"] and theirs["closes"] == 6
    assert mine["backend"] == "cpu" and \
        mine["crypto.verify.kernel-launches"] == 0


def test_pipeline_tool_on_the_cpu(tmp_path, capsys):
    rc, lines, files = run_tool(
        "pipeline_bench", ["--closes", "1", "--close-txs", "20",
                           "--accounts", "40"], tmp_path, capsys)
    assert rc == 0 and files == []
    *rows, doc = lines
    assert [(r["backend"], r["shape"]) for r in rows] == \
        [("cpu", "pay"), ("cpu", "mixed")]
    assert all(r["close_thread_sql_point_reads"]["on"] == 0 for r in rows)
    assert doc["parity"][0]["hashes_identical"] is True
    assert doc["card"] is None and doc["backends"] == ["cpu"]


def test_soak_tool_on_the_cpu(tmp_path, capsys):
    rc, lines, files = run_tool(
        "soak_bench", ["--rate", "20", "--duration", "3", "--accounts",
                       "60"], tmp_path, capsys)
    assert rc == 0 and files == []
    row, doc = lines
    assert row["sustained"]["submitted"] > 0
    assert row["sustained"]["admit_status_counts"] == {
        "0": row["sustained"]["submitted"]}
    assert row["parity"]["hashes_identical"] is True
    assert row["disabled_cost"]["off_close_p50_ms"] > 0
    assert doc["runs"][0]["parity_identical"] is True
