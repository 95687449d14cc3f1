"""The port's fixpoint stop: ``contract_fixpoint`` gives ``contract_batch``'s
rows, and ``federated_ratify`` (which uses it)
still equals the JAX ``while_loop`` version while running fewer trips than
the fixed N.  Tolerance: exact equality of every boolean."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_core_tpu.ops import quorum as JQ
from stellar_core_tpu_torch.ops import quorum as Q


def _random_qsets(rng, n, k):
    """n random 2-level qsets over n nodes, thresholds including 0."""
    out = []
    for _ in range(n):
        vals = sorted(int(v) for v in rng.choice(n, int(rng.integers(0, 4)),
                                                 replace=False))
        inners = []
        for _ in range(int(rng.integers(0, k + 1))):
            iv = sorted(int(v) for v in rng.choice(n, int(rng.integers(1, 5)),
                                                   replace=False))
            inners.append((int(rng.integers(0, len(iv) + 1)), iv))
        thr = int(rng.integers(0, len(vals) + len(inners) + 1))
        out.append((thr, vals, inners))
    return out


def _chain(n):
    """Node i trusts only node i+1, and the last node only itself."""
    return [(1, [min(i + 1, n - 1)], []) for i in range(n)]


def _count_trips(monkeypatch):
    trips = []
    real = Q._contract_trip

    def counted(qsets, m):
        trips.append(1)
        return real(qsets, m)

    monkeypatch.setattr(Q, "_contract_trip", counted)
    return trips


@pytest.mark.parametrize("seed", range(15))
def test_fixpoint_rows_equal_fixed_trips(seed):
    rng = np.random.default_rng(40 + seed)
    n = 12
    qt = Q.build_qset_tensor(_random_qsets(rng, n, 3), list(range(n)),
                             max_inner=3, device="cpu")
    members = torch.from_numpy(rng.random((20, n)) < 0.8)
    want = Q.contract_batch(qt, members)
    assert torch.equal(Q.contract_fixpoint(qt, members), want)


@pytest.mark.parametrize("n", [4, 7])
def test_chain_needs_every_trip(n, monkeypatch):
    """Without the last node, the chain unravels one node a trip from its
    end: the slowest a contraction can be (N - 1 trips that drop a node,
    then the one that finds nothing to drop)."""
    qt = Q.build_qset_tensor(_chain(n), list(range(n)), device="cpu")
    members = torch.tensor([[True] * (n - 1) + [False]])
    one_trip = Q._contract_trip(qt, members)
    assert one_trip.tolist() == [[True] * (n - 2) + [False, False]]
    trips = _count_trips(monkeypatch)
    got = Q.contract_fixpoint(qt, members)
    assert got.tolist() == [[False] * n]
    assert len(trips) == n
    assert torch.equal(got, Q.contract_batch(qt, members))


@pytest.mark.parametrize("n_orgs", [2, 4, 8])
def test_a_quorum_stops_after_one_check(monkeypatch, n_orgs):
    """Every node of ``n_orgs`` orgs of 4 voted: nothing drops, so the loop
    stops after its first trip instead of running N trips."""
    nodes = list(range(4 * n_orgs))
    orgs = [(3, nodes[o:o + 4]) for o in range(0, len(nodes), 4)]
    qt = Q.build_qset_tensor([(n_orgs - 1, [], orgs)] * len(nodes), nodes,
                             device="cpu")
    trips = _count_trips(monkeypatch)
    voted = torch.ones((1, len(nodes)), dtype=torch.bool)
    assert bool(Q.federated_ratify(Q.local_qset(qt, 0), qt, voted)[0])
    assert len(trips) == 1


@pytest.mark.parametrize("seed", range(3))
def test_fixpoint_ratify_matches_jax_while_loop(seed, monkeypatch):
    rng = np.random.default_rng(60 + seed)
    n = 10
    qsets = _random_qsets(rng, n, 3)
    qsets[0] = (2, [0, 1, 2], [(2, [3, 4, 5])])
    jt = JQ.build_qset_tensor(qsets, list(range(n)), max_inner=3)
    tt = Q.build_qset_tensor(qsets, list(range(n)), max_inner=3,
                             device="cpu")
    voted = rng.random((16, n)) < 0.75
    trips = _count_trips(monkeypatch)
    for i in range(n):
        jl = JQ.QSetTensor(*(t[i] for t in jt))
        want = np.asarray(JQ.federated_ratify(jl, jt, jnp.asarray(voted)))
        got = Q.federated_ratify(Q.local_qset(tt, i), tt,
                                 torch.from_numpy(voted))
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(trips) < n * n   # fewer than the fixed N trips per call
