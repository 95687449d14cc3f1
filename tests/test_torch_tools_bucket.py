"""The port's ``tools/bucket_scale_bench`` and ``tools/read_bench``
against the repository's ``tools/bucket_scale_bench.py`` and
``tools/read_bench.py`` on the CPU at 10,000 entries: the bucket-list
hash of the indexed and the unindexed build (the port's native merge
against the JAX package's), and a live ``cpu`` node's point reads served
by each tier with no SQL query.

Tolerance: exact (hashes, counts).
"""
import pytest

from stellar_core_tpu_torch.tools import bucket_scale_bench as BSB
from stellar_core_tpu_torch.tools import read_bench as RB

from .test_torch_tools import run_tool

N_ENTRIES, PER_CLOSE = 10_000, 1_000


@pytest.mark.parametrize("indexed", [True, False])
def test_bucket_list_hash_equals_the_jax_tools(indexed, tmp_path):
    from tools.read_bench import build_list

    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mine, _, seq = BSB.build_list(N_ENTRIES, PER_CLOSE, str(tmp_path / "p"),
                                  indexed)
    theirs, close_times = build_list(N_ENTRIES, PER_CLOSE,
                                     str(tmp_path / "j"), indexed)
    assert seq - 1 == len(close_times) == N_ENTRIES // PER_CLOSE
    assert mine.hash() == theirs.hash()
    assert sum(1 for _ in mine.iter_live_entries()) == N_ENTRIES


def test_point_reads_served_equal_the_jax_tool(monkeypatch):
    from stellar_core_tpu.utils import device as jax_device
    from tools.read_bench import sql_free_node_check

    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)
    row = RB.sql_free_node_check("cpu")
    sql_queries, served = sql_free_node_check()
    assert row["sql_queries_point_lookup"] == sql_queries == 0
    assert row["point_reads_served_by"] == served
    assert served["bucket"] > 0


def test_bucket_scale_tool_on_the_cpu(tmp_path, capsys):
    rc, lines, files = run_tool(
        "bucket_scale_bench", [str(N_ENTRIES), str(PER_CLOSE)], tmp_path,
        capsys)
    assert rc == 0 and files == []
    out = lines[-1]
    assert out["streamed_entries"] == N_ENTRIES
    assert out["bucket_hash"] == out["bucket_hash_noindex"]
    assert out["card"] is None


def test_read_tool_on_the_cpu(tmp_path, capsys):
    rc, lines, files = run_tool(
        "read_bench", [str(N_ENTRIES), str(PER_CLOSE), "500"], tmp_path,
        capsys)
    assert rc == 0 and files == []
    out = lines[-1]
    assert out["hash_bit_identical"] is True
    assert out["sql_queries_point_lookup"] == 0
    assert [n["backend"] for n in out["nodes"]] == ["cpu"]
    assert out["point_reads"] == 500
