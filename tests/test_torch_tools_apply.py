"""The port's ``tools/parallel_apply_bench`` against the repository's
``tools/parallel_apply_bench.py`` on the CPU (``cpu`` / ``host`` nodes):
per-close fingerprints of the deterministic workloads, then the tool at a
tiny size through its ``main`` (its grid, the parity report's
subprocesses, the scaling summary).

Tolerance: exact (per-close ledger hash, bucket-list hash, sha256 of the
meta; hit counters).
"""
import pytest

from stellar_core_tpu_torch.tools import parallel_apply_bench as PAB

from .test_torch_tools import run_tool

CLOSES, CLOSE_TXS = 2, 40


@pytest.mark.parametrize("shape,workers", [("pay", 0), ("pay", 2),
                                           ("pool", 0), ("pool", 2)])
def test_fingerprints_equal_the_jax_tool(shape, workers):
    from tools.parallel_apply_bench import fingerprint_workload

    mine, mine_stats = PAB.fingerprint_workload(
        shape, workers, True, CLOSES, CLOSE_TXS, backend="cpu")
    theirs, their_stats = fingerprint_workload(shape, workers, True, CLOSES,
                                               CLOSE_TXS)
    assert mine == theirs and len(mine) == CLOSES
    for key in ("native_hits", "native_declines", "aborts", "fee_batch"):
        assert mine_stats[key] == their_stats[key], key


def test_grid_arms_equal_the_jax_tools_grid():
    """The r16 grid: 46 arms over the four shapes, in the JAX tool's
    order (``main``'s four loops)."""
    shapes = PAB.SHAPES
    want = [(s, w, True, True, False) for s in shapes for w in (0, 1, 2, 4)]
    want += [(s, w, True, fee, pipe) for s in shapes
             for fee, pipe in ((True, True), (False, False), (False, True))
             for w in (1, 4)]
    want += [(s, 2, True, True, True) for s in ("pay", "mixed")]
    want += [(s, 4, False, True, False) for s in shapes]
    assert PAB.grid_arms(shapes) == want and len(want) == 46
    assert PAB.grid_arms(["pool"]) == [a for a in want if a[0] == "pool"]


def test_parallel_apply_tool_on_the_cpu(tmp_path, capsys):
    rc, lines, files = run_tool(
        "parallel_apply_bench", ["--shapes", "pool", "--closes", "1",
                                 "--close-txs", "20", "--parity-closes",
                                 "1"], tmp_path, capsys)
    assert rc == 0 and files == []
    *rows, doc = lines
    assert [(r["workers"], r["native"], r["fee_kernel"], r["pipelined"])
            for r in rows] == [a[1:3] + (a[2] and a[3], a[4])
                               for a in PAB.grid_arms(["pool"])]
    assert all(r["backend"] == "cpu" and
               r["crypto.verify.kernel-launches"] == 0 for r in rows)
    assert doc["parity_identical"] is True and doc["aborts_total"] == 0
    assert doc["backends"] == ["cpu"] and doc["cuda_vs_cpu"] == []
    assert {r["native_hit_rate"] for r in rows if r["native"]} == {1.0}
