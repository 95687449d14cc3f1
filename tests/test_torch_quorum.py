"""The port's quorum ops against the JAX package's, on seeded random
2-level quorum sets and the hand-built cases of tests/test_quorum.py.
Tolerance: exact equality of every boolean."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_core_tpu.ops import quorum as JQ
from stellar_core_tpu_torch.ops import quorum as Q


def _random_qsets(rng, n, k):
    """n random 2-level qsets over n nodes, up to k inner sets each,
    thresholds including 0 (never satisfied / never blocked)."""
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


def _pair(qsets, n, k):
    nodes = list(range(n))
    return (JQ.build_qset_tensor(qsets, nodes, max_inner=k),
            Q.build_qset_tensor(qsets, nodes, max_inner=k, device="cpu"))


def _np(x):
    return np.asarray(x)


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_slice_vblocking_hits_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = 10, 3
    jt, tt = _pair(_random_qsets(rng, n, k), n, k)
    sets = rng.random((n, 24, n)) < 0.5   # per node: 24 candidate sets
    js, ts = jnp.asarray(sets), torch.from_numpy(sets)
    np.testing.assert_array_equal(Q._hits(tt, ts).numpy(),
                                  _np(JQ._hits(jt, js)))
    np.testing.assert_array_equal(Q.is_quorum_slice(tt, ts).numpy(),
                                  _np(JQ.is_quorum_slice(jt, js)))
    np.testing.assert_array_equal(Q.is_v_blocking(tt, ts).numpy(),
                                  _np(JQ.is_v_blocking(jt, js)))


@pytest.mark.parametrize("seed", SEEDS)
def test_contraction_and_is_quorum_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n, k = 9, 2
    jt, tt = _pair(_random_qsets(rng, n, k), n, k)
    members = rng.random((12, n)) < 0.7
    got = Q.contract_batch(tt, torch.from_numpy(members)).numpy()
    np.testing.assert_array_equal(
        got, _np(JQ.contract_batch(jt, jnp.asarray(members))))
    for row in range(4):
        m = members[row]
        one = Q.contract_to_maximal_quorum(tt, torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(
            one, _np(JQ.contract_to_maximal_quorum(jt, jnp.asarray(m))))
        np.testing.assert_array_equal(one, got[row])
        for i in (0, n - 1):
            jl = JQ.QSetTensor(*(t[i] for t in jt))
            assert bool(Q.is_quorum(Q.local_qset(tt, i), tt,
                                    torch.from_numpy(m))) == \
                bool(JQ.is_quorum(jl, jt, jnp.asarray(m)))


@pytest.mark.parametrize("seed", SEEDS)
def test_federated_accept_ratify_match_jax(seed):
    rng = np.random.default_rng(20 + seed)
    n, k = 10, 3
    qsets = _random_qsets(rng, n, k)
    qsets[0] = (2, [0, 1, 2], [(2, [3, 4, 5])])   # a satisfiable local qset
    jt, tt = _pair(qsets, n, k)
    voted = rng.random((16, n)) < 0.75
    accepted = rng.random((16, n)) < 0.4
    for i in range(n):
        jl = JQ.QSetTensor(*(t[i] for t in jt))
        tl = Q.local_qset(tt, i)
        jr = JQ.federated_ratify(jl, jt, jnp.asarray(voted | accepted))
        tr = Q.federated_ratify(tl, tt, torch.from_numpy(voted | accepted))
        np.testing.assert_array_equal(tr.numpy(), _np(jr))
        ja = JQ.federated_accept(jl, jt, jnp.asarray(voted),
                                 jnp.asarray(accepted))
        ta = Q.federated_accept(tl, tt, torch.from_numpy(voted),
                                torch.from_numpy(accepted))
        np.testing.assert_array_equal(ta.numpy(), _np(ja))


def test_threshold_zero_never_blocks():
    t = Q.build_qset_tensor([(0, [], [])], [0], device="cpu")
    assert not bool(Q.is_v_blocking(Q.local_qset(t, 0),
                                    torch.tensor([[True]]))[0])


def test_ratify_requires_local_slice():
    nodes = list(range(4))
    qsets = [(2, [0, 1], []), (2, [0, 1], []),
             (2, [2, 3], []), (2, [2, 3], [])]
    t = Q.build_qset_tensor(qsets, nodes, device="cpu")
    voted = torch.tensor([[True, True, False, False]])
    local3 = Q.local_qset(t, 3)
    assert not bool(Q.federated_ratify(local3, t, voted)[0])
    assert not bool(Q.federated_accept(local3, t, voted,
                                       torch.zeros_like(voted))[0])
    assert bool(Q.federated_ratify(Q.local_qset(t, 0), t, voted)[0])


def test_accept_through_v_blocking_path():
    nodes = list(range(4))
    t = Q.build_qset_tensor([(3, nodes, []) for _ in nodes], nodes,
                            device="cpu")
    voted = torch.zeros((2, 4), dtype=torch.bool)
    accepted = torch.tensor([[False, True, True, False],
                             [False, True, False, False]])
    got = Q.federated_accept(Q.local_qset(t, 0), t, voted, accepted)
    assert got.tolist() == [True, False]


def test_qset_to_plain_depth_fallback():
    """tests/test_quorum.py's case on the port: a 2-level qset has a
    tensor form, a 3-level one has none (the host walk takes it)."""
    from stellar_core_tpu_torch.scp import make_qset
    from stellar_core_tpu_torch.scp.local_node import qset_to_plain
    from stellar_core_tpu_torch.xdr import types as T

    a, b = b"\x01" * 32, b"\x02" * 32
    two = T.SCPQuorumSet.make(
        threshold=1, validators=[T.account_id(a)],
        innerSets=[make_qset(1, [b])])
    assert qset_to_plain(two) is not None
    three = T.SCPQuorumSet.make(
        threshold=1, validators=[],
        innerSets=[T.SCPQuorumSet.make(
            threshold=1, validators=[T.account_id(a)],
            innerSets=[make_qset(1, [b])])])
    assert qset_to_plain(three) is None
