"""Live SCP with its tallies on the card: a 4-validator signed network
(``chip_smoke.Network``) with ``tally_backend="both"`` on ``cuda`` runs 2
slots; every delivery round's envelopes go through the CUDA verify kernel
as one batch.  It imports only torch, numpy and the port (the GPU host has
no jax) and skips with a reason where there is no GPU.  On a GPU host,
without the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_scp.py -m cuda --noconftest -q

Tolerance: equality of values and counters; no TallyMismatch."""
import pytest
import torch

import stellar_core_tpu_torch.scp as scp_pkg
from chip_smoke import batch_verifier, run_scp
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.ops import ed25519_cuda
from stellar_core_tpu_torch.utils.device import pad_signature_batch
from stellar_core_tpu_torch.xdr import types as xdr_types


@pytest.mark.cuda
def test_four_validators_externalize_with_tallies_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    sizes = []
    verify = batch_verifier(ed25519_cuda.verify_batch, pad_signature_batch,
                            dev, sizes)
    before = ed25519_cuda.launches
    net, values, _ = run_scp(scp_pkg, xdr_types, ref, sha256, verify, 2,
                             device=dev, n_orgs=1, org_size=4, top_thr=1,
                             inner_thr=3)
    assert len(set(values)) == 2
    for node in net.nodes:
        assert [node.get_externalized_value(s) for s in (1, 2)] == values
    engines = [s.tally for node in net.nodes for s in node.slots.values()]
    assert all(e.device.type == "cuda" for e in engines)
    assert sum(e.tensor_tallies for e in engines) > 0
    assert sum(e.host_fallbacks for e in engines) == 0
    rounds = net.stats["rounds"]
    assert ed25519_cuda.launches - before == rounds == len(sizes)
    assert net.stats["forged_refused"] == 4 * rounds
