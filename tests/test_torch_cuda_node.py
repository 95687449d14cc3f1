"""A port standalone node with its close's signature batch on the card
(``chip_smoke.run_node``): 256 accounts, one close of 256 payments through
``recv_transaction`` and ``manual_close()``, then a peer's set of 256
payments with every 32nd signature forged through ``close_ledger``.  Every
close launches the CUDA verify kernel once on 256 rows, whose verdicts
answer every signature; the 8 forged txs are ``txBAD_AUTH``; a
``CRYPTO_BACKEND="cpu"`` port node fed alike gives the same ledger hash,
bucket-list hash and meta bytes after every close.  It imports only torch,
numpy and the port (the GPU host has no jax) and skips with a reason where
there is no GPU.  On a GPU host, without the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_node.py -m cuda --noconftest -q

Tolerance: equality of results, counts and bytes."""
import pytest
import torch

from chip_smoke import run_node
from stellar_core_tpu_torch.ops import ed25519_cuda


@pytest.mark.cuda
def test_node_closes_payments_with_forgeries_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    before = ed25519_cuda.launches
    run = run_node(torch.device("cuda"), n_accounts=256, payment_closes=1,
                   forge_every=32)
    closes = run["closes"]
    assert [c["kind"] for c in closes] == ["seed", "payments", "forged"]
    assert ed25519_cuda.launches - before == run["launches"] == 3
    assert all(c["launches"] == 1 and c["host_verifies"] == 0
               for c in closes)
    assert [c["padded"] for c in closes] == [256, 256, 256]
    assert closes[1]["results"] == {"txSUCCESS": 256}
    assert closes[2]["results"] == {"txSUCCESS": 248, "txBAD_AUTH": 8}
    assert all(c["equal_to_cpu_node"] for c in closes)
    node_a = run["apps"][0]
    assert node_a.device.type == "cuda"
    assert node_a.herder.scp.tally_device.type == "cuda"
