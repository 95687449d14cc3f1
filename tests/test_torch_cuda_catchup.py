"""BASELINE config #4's replay path on the card, at a small size
(``chip_smoke.run_catchup``): a ``cpu``-backend publisher with 256
accounts closes 6 ledgers of 256 payments and a peer's set of 256 with
every 32nd signature forged (ledgers 3-9), then empty ledgers to
checkpoint 15.  Cold joiner A replays it all (complete) with
``CRYPTO_BACKEND="cuda"`` on the GPU, B (complete) on ``"cpu"``, and C
(minimal, to the forged ledger) on the GPU: buckets at checkpoint 7, then
ledgers 8 and 9 replayed.  Every replayed ledger with signatures is one
launch of the CUDA verify kernel at 256 rows, by the kernel's own count;
every joiner's header and bucket-list hashes equal the publisher's at
every seq they share, and A's results for the forged ledger equal B's.
It imports only torch, numpy and the port (the GPU host has no jax) and
skips with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_catchup.py -m cuda --noconftest -q

Tolerance: equality of hashes, results and counts."""
import pytest
import torch

from chip_smoke import run_catchup
from stellar_core_tpu_torch.ops import ed25519_cuda


@pytest.mark.cuda
def test_catchup_replay_on_card_equals_the_cpu_joiner(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    before = ed25519_cuda.launches
    run = run_catchup(torch.device("cuda"), str(tmp_path), n_accounts=256,
                      payment_ledgers=6, forge_every=32, checkpoints=2)
    pub = run["publisher"]
    assert pub["signed_ledgers"] == list(range(2, 10)) and pub["lcl"] == 15
    a, b, c = (run["joiners"][k] for k in "ABC")
    assert a["launches"] == 8 and c["launches"] == 2 and b["launches"] == 0
    assert ed25519_cuda.launches - before == 10
    assert a["batches"] == [[256]] * 8 and c["batches"] == [[256]] * 2
    assert a["host_verifies"] == c["host_verifies"] == 0
    assert c["replayed_seqs"] == [8, 9] and c["lcl"] == 9
    assert a["forged_results"] == b["forged_results"]
    assert a["forged_results"].count("txBAD_AUTH") == 8
    assert all(j["equal_to_publisher"] for j in (a, b, c))
    assert a["app"].device.type == "cuda"
