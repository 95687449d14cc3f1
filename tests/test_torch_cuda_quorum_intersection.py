"""The quorum-intersection checker's device tier on the card: it gives the
numpy tier's answer on the 16-node twisted clique, and its contraction of
one 256-row chunk over 1,100 nodes equals the numpy tier's rows.  It
imports only torch, numpy and the port (the GPU host has no jax) and skips
with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_quorum_intersection.py -m cuda \
        --noconftest -q

Tolerance: exact equality of verdicts, scan counts and every row."""
import numpy as np
import pytest
import torch

from chip_smoke import clique_ids, twisted_clique
from stellar_core_tpu_torch.herder import quorum_intersection as QI
from stellar_core_tpu_torch.scp import local_node as LN


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device tier runs on cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_tier_on_card_equals_numpy_tier_on_16_clique():
    dev = _cuda()
    qmap = twisted_clique(LN.make_qset, clique_ids(16))
    host = QI.check_quorum_intersection(qmap, use_native=False,
                                        use_device=False)
    card = QI.check_quorum_intersection(qmap, use_native=False, device=dev)
    assert (host.ok, host.scanned, host.tier) == (True, 4003, "numpy")
    assert (card.ok, card.scanned, card.tier) == (True, 4003, "device")


@pytest.mark.cuda
def test_one_chunk_of_1100_nodes_on_card_equals_numpy_rows():
    dev = _cuda()
    rng = np.random.default_rng(1100)
    n, k = 1100, 4
    ids = [i.to_bytes(32, "big") for i in range(n)]
    qmap = {}
    for x in ids:
        inners = [LN.make_qset(int(rng.integers(2, 4)),
                               [ids[j] for j in rng.choice(n, 4, False)])
                  for _ in range(k)]
        vals = [ids[j] for j in rng.choice(n, 2, False)]
        qmap[x] = LN.make_qset(int(rng.integers(3, 6)), vals, inners)
    # rows of 80-100% of the nodes: about a third of them drop over ~20
    # trips, some to nothing
    masks = rng.random((QI.BATCH, n)) < rng.uniform(0.8, 1.0, (QI.BATCH, 1))
    card = QI._Contractor(ids, qmap, True, dev)
    host = QI._Contractor(ids, qmap, False)
    got = card.contract(masks)
    np.testing.assert_array_equal(got, host.contract(masks))
    assert got.any(axis=1).sum() not in (0, QI.BATCH)
