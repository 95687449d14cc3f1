"""The port's benchmark tools on the card, at small sizes: each ``cuda`` arm
runs its node on the GPU (the verify kernel for every close's signature
batch, the tallies on the card) and equals a ``cpu`` node of the same
process, and launches the kernel, by the kernel's own count:

- ``parallel_apply_bench``: per-close fingerprints (pay and pool, workers
  2, 2 closes of 100 txs), one launch a close at least;
- ``pipeline_bench`` and ``soak_bench``: the parity passes, their last
  ledger hash equal to the ``cpu`` node's;
- ``scp_forensics_bench``: the induced-fork dump at seed 14 equals the
  ``cpu`` network's;
- ``read_bench``: the SQL-free point reads of a ``cuda`` node;
- ``quorum_tier_bench``: the device tier on the card, its contractor
  chunks held to a host fixpoint, the verdicts of the ``cpu`` tier;
- ``chaos_bench --netobs``: the core-4 observatory tier on a ``cuda`` and a
  ``cpu`` arm, tracing on and off: the five gates hold on both, the
  ``cuda`` arm's digests equal the ``cpu`` arm's, and only the ``cuda``
  arm launched the kernel.

It imports only torch and the port (the GPU host has no jax) and skips
with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_tools.py -m cuda --noconftest -q

Tolerance: equality of hashes, fingerprints, verdicts and counts."""
import pytest
import torch

from stellar_core_tpu_torch.ops import ed25519_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["pay", "pool"])
def test_apply_fingerprints_on_the_card_equal_the_cpu_node(card, shape):
    from stellar_core_tpu_torch.tools.parallel_apply_bench import \
        fingerprint_workload

    want, _ = fingerprint_workload(shape, 2, True, 2, 100, backend="cpu")
    before = ed25519_cuda.launches
    got, stats = fingerprint_workload(shape, 2, True, 2, 100,
                                      backend="cuda")
    torch.cuda.synchronize()
    assert got == want
    assert ed25519_cuda.launches - before >= 2   # the seeding's and a close's
    assert stats["aborts"] == 0


@pytest.mark.cuda
def test_parity_passes_on_the_card_equal_the_cpu_node(card):
    from stellar_core_tpu_torch.tools import pipeline_bench, soak_bench

    for want, got in (
            (pipeline_bench.parity_pass("cpu", 2),
             pipeline_bench.parity_pass("cuda", 2)),
            (soak_bench.parity_pass("cpu"), soak_bench.parity_pass("cuda"))):
        assert got["hashes_identical"] and want["hashes_identical"]
        assert got["last_ledger_hash"] == want["last_ledger_hash"]
        assert got["crypto.verify.kernel-launches"] > 0
        assert want["crypto.verify.kernel-launches"] == 0
        assert got["card"] and "," in got["card"]


@pytest.mark.cuda
def test_fork_probe_on_the_card_equals_the_cpu_network(card):
    from stellar_core_tpu_torch.tools.scp_forensics_bench import fork_probe

    got, want = fork_probe("cuda", 14, 10.0), fork_probe("cpu", 14, 10.0)
    assert got["dump_sha256"] == want["dump_sha256"]
    assert got["attributed_to_byzantine"] and got["rerun_dump_identical"]
    assert got["crypto.verify.kernel-launches"] > 0


@pytest.mark.cuda
def test_sql_free_reads_on_a_cuda_node(card):
    from stellar_core_tpu_torch.tools.read_bench import sql_free_node_check

    got, want = sql_free_node_check("cuda"), sql_free_node_check("cpu")
    assert got["sql_queries_point_lookup"] == 0
    assert got["point_reads_served_by"] == want["point_reads_served_by"]
    assert got["crypto.verify.kernel-launches"] > 0


@pytest.mark.cuda
def test_device_tier_on_the_card_equals_the_cpu_tier(card):
    from stellar_core_tpu_torch.tools.quorum_tier_bench import tier_row

    row = tier_row(16, ["cuda", "cpu"])
    gpu, cpu = row["python_device"]["cuda"], row["python_device"]["cpu"]
    assert (gpu["ok"], gpu["scanned"]) == (cpu["ok"], cpu["scanned"]) == \
        (True, 4003)
    assert gpu["contractor"]["chunks"] > 0
    assert gpu["contractor"]["mismatched_rows"] == 0


@pytest.mark.cuda
def test_netobs_core4_on_the_card_equals_the_cpu_arm(card):
    from stellar_core_tpu_torch.tools import LAUNCHES
    from stellar_core_tpu_torch.tools.chaos_bench import run_netobs

    doc = run_netobs(["core4"], 11, ["cuda", "cpu"])
    res = doc["tiers"]["core4"]
    for b in ("cuda", "cpu"):
        g = res[b]["gates"]
        assert g["hop_records_nonzero"] and g["coverage_percentiles_present"]
        assert g["inert_hashes_and_meta"] and g["tracing_overhead_ok"]
        assert g["attribution_ok"]
    for mode in ("on", "off"):
        assert res["cuda"][mode]["digests"] == res["cpu"][mode]["digests"]
        assert res["cuda"][mode]["arm"][LAUNCHES] > 0
        assert res["cpu"][mode]["arm"][LAUNCHES] == 0
        assert res["cuda"][mode]["arm"]["overlay_launched_batches"] > 0
