"""The port's entry points on the card: ``entry()``, ``bench_device.run``,
``bench_sharded`` and the bench at a small size (512 signatures, 2 closes
of 50 transactions a shape), each launching the CUDA verify kernel and
equal to the plain torch version on the same inputs.  It imports only
torch, numpy and the port (the GPU host has no jax) and skips with a
reason where there is no GPU.  On a GPU host, without the JAX-importing
conftest:

    python -m pytest tests/test_torch_cuda_entry.py -m cuda --noconftest -q

Tolerance: exact equality of every verdict and count."""
import gc

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import bench, bench_device, entry
from stellar_core_tpu_torch.models import admission as A
from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_entry_runs_on_the_card_and_equals_the_cpu_step():
    _card()
    fn, (batch,) = entry.entry()
    assert batch.pubkeys.device.type == "cuda"
    before = ed25519_cuda.launches
    got = fn(batch)
    assert ed25519_cuda.launches == before + 1
    _, (cpu_batch,) = entry.entry(device="cpu")
    for g, w in zip(got, fn(cpu_batch)):
        assert torch.equal(g.cpu(), w)
    assert bool(got[0].all())


@pytest.mark.cuda
def test_bench_small_on_the_card():
    dev = _card()
    before = ed25519_cuda.launches
    assert gc.isenabled()
    out = bench.run(dev, n_sigs=512, n_closes=2, close_txs=50)
    # the bench gives back the collector its nodes' DEFERRED_GC turned off
    assert gc.isenabled()
    line = out["line"]
    assert (line["kernel"], line["n_signatures"], line["n_padded"],
            line["verdicts_true"]) == ("cuda", 512, 512, 512)
    assert line["kernel_equal_to_plain"] is True
    assert line["close_ledger_hashes_equal"] is True
    # the stage (1 + 3 + 3), prevalidate_signatures, 6 closes of node A
    assert ed25519_cuda.launches - before == 7 + 1 + 6
    pk, sg, mg = out["batch"]
    stage = bench_device.run(pk, sg, mg, device=dev)
    padded = [torch.as_tensor(x, device=dev) for x in stage["padded"]]
    assert np.array_equal(stage["verdicts"],
                          ed25519_kernel.verify_batch(*padded).cpu().numpy())
    assert stage["kernel_ms"] > 0


@pytest.mark.cuda
def test_bench_sharded_on_the_cards():
    _card()
    before = ed25519_cuda.launches
    res = A.bench_sharded(n_sigs=1024, n_validators=16, n_candidates=8)
    n = torch.cuda.device_count()
    assert res["n_devices"] == n and res["platform"] == "cuda"
    assert res["device_kind"] == torch.cuda.get_device_name(0)
    assert ed25519_cuda.launches - before == 2 * n
