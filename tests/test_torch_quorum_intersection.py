"""The port's quorum-intersection checker (``stellar_core_tpu_torch.herder``)
on the CPU: the cases of tests/test_quorum_intersection.py against brute
force, and the same qmaps, built in both packages from the same node ids
and quorum-set tuples, through the port's and the JAX package's checkers
in the native, numpy and device tiers (the port's device tier on
``device="cpu"``).  Also the repaired contraction trip at 1,100 nodes, the
device contractor's rows against the JAX package's, the port's native
library and the port's quorum tracker.

Tolerance: exact equality of verdicts, scan counts, tiers, splits and
every contracted row."""
import itertools
import random
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from chip_smoke import clique_ids, tiered_orgs, twisted_clique
from stellar_core_tpu.herder import quorum_intersection as JQI
from stellar_core_tpu.scp import local_node as JLN
from stellar_core_tpu_torch import native
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.herder import quorum_intersection as QI
from stellar_core_tpu_torch.herder.quorum_tracker import QuorumTracker
from stellar_core_tpu_torch.ops import quorum as Q
from stellar_core_tpu_torch.scp import local_node as LN

REPO = Path(__file__).resolve().parents[1]


def ids(n):
    return [bytes([i]) * 32 for i in range(n)]


def qset(threshold, validators, inner=(), ln=LN):
    return ln.make_qset(threshold, validators,
                        [ln.make_qset(t, v) for t, v in inner])


def brute_force_disjoint(qmap, ln=LN):
    """Exhaustive reference: every subset that is a quorum, against every
    other; disjoint pair -> False."""
    nodes = sorted(qmap)
    quorums = []
    for r in range(1, len(nodes) + 1):
        for combo in itertools.combinations(nodes, r):
            s = set(combo)
            if all(ln.is_quorum_slice(qmap[n], s) for n in s):
                quorums.append(s)
    return all(a & b for a in quorums for b in quorums)


def assert_split_is_two_quorums(qmap, res):
    q1, q2 = res.split
    assert q1 and q2 and not (q1 & q2)
    assert all(LN.is_quorum_slice(qmap[x], q1) for x in q1)
    assert all(LN.is_quorum_slice(qmap[x], q2) for x in q2)


# -- the topologies, built by either package's local_node (``ln``) ----------

def core4(ln):
    n = ids(4)
    return {x: qset(3, n, ln=ln) for x in n}


def split6(ln):
    n = ids(6)
    left, right = n[:3], n[3:]
    qmap = {x: qset(2, left, ln=ln) for x in left}
    qmap.update({x: qset(2, right, ln=ln) for x in right})
    return qmap


def majority(thr):
    def build(ln):
        n = ids(4)
        return {x: qset(thr, n, ln=ln) for x in n}
    return build


def orgs6(ln):
    n = ids(6)
    orgs = [(2, n[0:2]), (2, n[2:4]), (2, n[4:6])]
    return {x: qset(2, [], orgs, ln=ln) for x in n}


def random_flat(seed, lo=3, hi=7):
    """``test_randomized_vs_brute_force``'s (seeds 0-7),
    ``test_device_path_matches_host``'s (100-103, 3-6 nodes) and
    ``test_native_vs_python_enumerator``'s (2000-2007) topologies."""
    def build(ln):
        rng = random.Random(seed)
        nodes = ids(rng.randint(lo, hi))
        qmap = {}
        for x in nodes:
            k = rng.randint(1, len(nodes))
            members = rng.sample(nodes, k)
            qmap[x] = qset(rng.randint(1, k), members, ln=ln)
        return qmap
    return build


def org36(ln):
    n = ids(36)
    orgs = [(2, n[3 * i:3 * i + 3]) for i in range(12)]
    return {x: qset(9, [], orgs, ln=ln) for x in n}


def split24(ln):
    n = ids(24)
    left_orgs = [(2, n[3 * i:3 * i + 3]) for i in range(4)]
    right_orgs = [(2, n[3 * i:3 * i + 3]) for i in range(4, 8)]
    qmap = {x: qset(3, [], left_orgs, ln=ln) for x in n[:12]}
    qmap.update({x: qset(3, [], right_orgs, ln=ln) for x in n[12:]})
    return qmap


def random_orgs(seed):
    """``test_org_reduction_vs_brute_force``'s topologies (1000-1011)."""
    def build(ln):
        rng = random.Random(seed)
        n_orgs = rng.randint(2, 3)
        sizes = [rng.randint(2, 3) for _ in range(n_orgs)]
        nodes = ids(sum(sizes))
        orgs, i = [], 0
        for s in sizes:
            orgs.append((rng.randint(1, s), nodes[i:i + s]))
            i += s
        thr = rng.randint(1, n_orgs)
        return {x: qset(thr, [], orgs, ln=ln) for x in nodes}
    return build


def budget8(ln):
    """``test_call_budget_reports_unknown``'s asymmetric 8-node network."""
    rng = random.Random(7)
    n = ids(8)
    qmap = {}
    for i, x in enumerate(n):
        members = rng.sample(n, 5 + (i % 3))
        qmap[x] = qset(3 + (i % 2), members, ln=ln)
    return qmap


def deep6(ln):
    n = ids(6)
    deep_inner = ln.make_qset(1, n[4:6], [ln.make_qset(2, n[2:4])])
    q = ln.make_qset(2, n[0:2], [deep_inner])
    return {x: q for x in n}


def clique16(ln):
    return twisted_clique(ln.make_qset, clique_ids(16))


def tiered(top_thr):
    """``chip_smoke.tiered_orgs`` cut to 65 orgs of 4 (5 core), 60 listed."""
    def build(ln):
        return tiered_orgs(ln.make_qset, [bytes([i // 256, i % 256]) * 16
                                          for i in range(260)],
                           top_thr, n_core=5, listed=60)
    return build


# ---------------------------------------------------------------------------
# the cases of tests/test_quorum_intersection.py, on the port
# ---------------------------------------------------------------------------

class TestTarjan:
    def test_two_components(self):
        a, b, c, d = ids(4)
        edges = {a: {b}, b: {a}, c: {d}, d: {c}}
        sccs = QI.tarjan_scc([a, b, c, d], edges)
        assert sorted(map(len, sccs)) == [2, 2]

    def test_chain_is_singletons(self):
        a, b, c = ids(3)
        edges = {a: {b}, b: {c}, c: set()}
        sccs = QI.tarjan_scc([a, b, c], edges)
        assert sorted(map(len, sccs)) == [1, 1, 1]


class TestChecker:
    def test_healthy_core4_intersects(self):
        res = QI.check_quorum_intersection(core4(LN), use_device=False)
        assert res.ok and res.scc_size == 4

    def test_split_network_detected(self):
        qmap = split6(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert not res.ok
        assert_split_is_two_quorums(qmap, res)

    def test_majority_threshold_boundary(self):
        res = QI.check_quorum_intersection(majority(2)(LN), use_device=False)
        assert not res.ok
        assert QI.check_quorum_intersection(majority(3)(LN),
                                            use_device=False).ok

    def test_inner_set_orgs(self):
        qmap = orgs6(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert res.ok == brute_force_disjoint(qmap)

    @pytest.mark.parametrize("seed", range(8))
    def test_randomized_vs_brute_force(self, seed):
        qmap = random_flat(seed)(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert res.ok == brute_force_disjoint(qmap), \
            f"seed {seed}: checker {res.ok}"

    def test_device_path_matches_host(self):
        """The device tier (on the CPU here, native off so that it runs)
        agrees with the host scan."""
        for seed in range(100, 104):
            qmap = random_flat(seed, 3, 6)(LN)
            host = QI.check_quorum_intersection(qmap, use_device=False)
            dev = QI.check_quorum_intersection(qmap, use_native=False,
                                               device="cpu")
            assert host.ok == dev.ok, f"seed {seed}"
            assert dev.tier in ("device", None)

    def test_contract_host_fixpoint(self):
        n = ids(4)
        qmap = core4(LN)
        assert QI._contract_host(set(n), qmap) == set(n)
        assert QI._contract_host(set(n[:2]), qmap) == set()

    def test_org_topology_36_nodes_scales(self):
        import time

        t0 = time.monotonic()
        res = QI.check_quorum_intersection(org36(LN), use_device=False)
        assert res.ok and res.scc_size == 36
        assert time.monotonic() - t0 < 30

    def test_org_topology_split_detected_at_scale(self):
        qmap = split24(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert not res.ok
        assert_split_is_two_quorums(qmap, res)

    @pytest.mark.parametrize("seed", range(1000, 1012))
    def test_org_reduction_vs_brute_force(self, seed):
        qmap = random_orgs(seed)(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert res.ok == brute_force_disjoint(qmap), f"seed {seed}"
        if not res.ok:
            assert_split_is_two_quorums(qmap, res)

    @pytest.mark.parametrize("seed", range(2000, 2008))
    def test_native_vs_python_enumerator(self, seed):
        qmap = random_flat(seed)(LN)
        nat = QI.check_quorum_intersection(qmap, use_device=False,
                                           use_native=True)
        py = QI.check_quorum_intersection(qmap, use_device=False,
                                          use_native=False)
        assert nat.ok == py.ok == brute_force_disjoint(qmap), f"seed {seed}"

    def test_interrupt_flag_aborts(self):
        import threading

        n = ids(8)
        qmap = {x: qset(5, n) for x in n}
        flag = threading.Event()
        flag.set()
        with pytest.raises(QI.InterruptedError_):
            QI.check_quorum_intersection(qmap, use_device=False,
                                         interrupt=flag)

    def test_call_budget_reports_unknown(self):
        qmap = budget8(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False,
                                           max_calls=1)
        assert res.ok is None and res.aborted
        res_py = QI.check_quorum_intersection(qmap, use_device=False,
                                              use_native=False, max_calls=1)
        assert res_py.ok is None and res_py.aborted

    def test_deep_nested_qsets_use_host_walk(self):
        qmap = deep6(LN)
        res = QI.check_quorum_intersection(qmap, use_device=False)
        assert res.ok == brute_force_disjoint(qmap)


# ---------------------------------------------------------------------------
# the port against the JAX package, tier by tier
# ---------------------------------------------------------------------------

TOPOLOGIES = {
    "core4": core4, "split6": split6, "majority2": majority(2),
    "majority3": majority(3), "orgs6": orgs6, "org36": org36,
    "split24": split24, "deep6": deep6, "clique16": clique16,
    "budget8": budget8,
    **{f"flat{s}": random_flat(s) for s in range(8)},
    **{f"flat{s}": random_flat(s, 3, 6) for s in range(100, 104)},
    **{f"orgs{s}": random_orgs(s) for s in range(1000, 1012)},
    **{f"flat{s}": random_flat(s) for s in range(2000, 2008)},
}
TIERS = {
    "native": {"use_native": True, "use_device": False},
    "numpy": {"use_native": False, "use_device": False},
    "device": {"use_native": False, "use_device": True},
}


def _port_and_jax(name, tier, **kw):
    port = QI.check_quorum_intersection(TOPOLOGIES[name](LN), device="cpu",
                                        **TIERS[tier], **kw)
    jax = JQI.check_quorum_intersection(TOPOLOGIES[name](JLN),
                                        **TIERS[tier], **kw)
    return port, jax


def _split_sets(res):
    return None if res.split is None else tuple(set(s) for s in res.split)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_port_equals_jax_checker(name, tier):
    port, jax = _port_and_jax(name, tier)
    assert (port.ok, port.scanned, port.scc_size, port.aborted, port.tier) \
        == (jax.ok, jax.scanned, jax.scc_size, jax.aborted, jax.tier)
    assert _split_sets(port) == _split_sets(jax)


def test_clique16_scans_as_the_tier_bench_counted():
    """The JAX package's count for the 16-node clique, in every port tier."""
    for tier, kw in TIERS.items():
        res = QI.check_quorum_intersection(clique16(LN), device="cpu", **kw)
        assert (res.ok, res.scanned, res.tier) == (True, 4003, tier)


@pytest.mark.parametrize("tier", ["native", "numpy", "device"])
def test_aborted_scan_matches_jax_and_names_its_tier(tier):
    """Under a call budget of 1 both packages abort with the same count;
    the port names the tier that was scanning, where the JAX package gives
    ``None`` for its Python tiers (and "native" for its native tier)."""
    port, jax = _port_and_jax("budget8", tier, max_calls=1)
    assert (port.ok, port.aborted, port.scanned, port.scc_size) == \
        (jax.ok, jax.aborted, jax.scanned, jax.scc_size)
    assert port.ok is None and port.aborted
    assert port.tier == tier
    assert jax.tier == ("native" if tier == "native" else None)


@pytest.mark.parametrize("top_thr", [2, 41])
def test_tiered_org_network_device_equals_numpy(top_thr):
    """``chip_smoke.tiered_orgs`` at 260 nodes: the port's device and numpy
    tiers agree on a low threshold's split and on a budget-aborted scan,
    and the split is two disjoint quorums."""
    qmap = tiered(top_thr)(LN)
    dev = QI.check_quorum_intersection(qmap, use_native=False, device="cpu",
                                       max_calls=600)
    host = QI.check_quorum_intersection(qmap, use_native=False,
                                        use_device=False, max_calls=600)
    assert (dev.ok, dev.scanned, dev.aborted, _split_sets(dev)) == \
        (host.ok, host.scanned, host.aborted, _split_sets(host))
    assert (dev.tier, host.tier) == ("device", "numpy")
    if top_thr == 2:
        assert dev.ok is False
        assert_split_is_two_quorums(qmap, dev)
    else:
        assert dev.ok is None and dev.aborted


def _random_2level(ln, n, seed):
    """A 2-level network over ``n`` nodes: orgs of 5, random thresholds,
    top-level validators, and one inner set listed twice by some nodes
    (it counts twice)."""
    rng = np.random.default_rng(seed)
    nodes = ids(n) if n < 256 else [i.to_bytes(32, "big") for i in range(n)]
    orgs = [nodes[o:o + 5] for o in range(0, n, 5)]
    qmap = {}
    for i, x in enumerate(nodes):
        picked = rng.choice(len(orgs), min(6, len(orgs)), replace=False)
        inners = [ln.make_qset(int(rng.integers(1, len(orgs[p]) + 1)),
                               orgs[p]) for p in picked]
        if i % 3 == 0:
            inners.append(inners[0])
        vals = [nodes[j] for j in rng.choice(n, 3, replace=False)]
        qmap[x] = ln.make_qset(int(rng.integers(2, len(inners) + 2)), vals,
                               inners)
    return nodes, qmap


@pytest.mark.parametrize("n,rows", [(40, 64), (70, 300)])
def test_contractor_rows_equal_jax_device_contractor(n, rows):
    """``_Contractor.contract`` on seeded random masks: the port's device
    tier (chunks of 256 rows that stop at the fixpoint) equals the JAX
    device tier (padded chunks of N fixed trips) and the port's numpy
    tier; 70 nodes is not a multiple of 64, 300 rows are two chunks."""
    nodes, qmap = _random_2level(LN, n, n)
    _, jqmap = _random_2level(JLN, n, n)
    masks = np.random.default_rng(rows).random((rows, n)) < np.linspace(
        0.5, 1.0, rows)[:, None]
    got = QI._Contractor(nodes, qmap, True, "cpu").contract(masks)
    want = JQI._Contractor(nodes, jqmap, True).contract(masks)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, QI._Contractor(nodes, qmap, False).contract(masks))
    assert 0 < got.any(axis=1).sum() < rows


# ---------------------------------------------------------------------------
# the repaired contraction: at most (B, N, K)
# ---------------------------------------------------------------------------

class _LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_contract_trip_at_1100_nodes_equals_numpy_trip():
    """One trip at B = 256, N = 1,100, K = 8 (the old AND-and-sum form
    needed a 2.5 G-element boolean) builds nothing larger than its qsets'
    members (N, K + 1, N) or the JAX einsum's (B, N, K), and equals the
    numpy tier's trip."""
    rng = np.random.default_rng(1100)
    b, n, k = 256, 1100, 8
    top_mem = rng.random((n, n)) < 2 / n
    top_thr = rng.integers(1, 6, n).astype(np.int32)
    inner_mem = rng.random((n, k, n)) < 4 / n
    inner_thr = rng.integers(0, 4, (n, k)).astype(np.int32)  # 0: padding
    m = rng.random((b, n)) < 0.85
    qt = Q.qset_from_numpy(top_mem, top_thr, inner_mem, inner_thr, "cpu")
    with _LargestTensor() as largest:
        got = Q._contract_trip(qt, torch.from_numpy(m)).numpy()
    assert largest.numel <= max(b * n * k, n * (k + 1) * n)
    # the numpy tier's trip (float64 products, exact for these counts)
    s = m.astype(np.float64)
    top = s @ top_mem.T
    inner_ct = (s @ inner_mem.reshape(n * k, n).T).reshape(b, n, k)
    inner_ok = (inner_ct >= inner_thr[None]) & (inner_thr[None] > 0)
    want = m & (top + inner_ok.sum(-1) >= top_thr[None])
    np.testing.assert_array_equal(got, want)
    assert 0 < (m & ~got).sum()


def test_live_tally_ops_stay_below_b_n_k():
    """``federated_accept`` with V local qsets over C statements (as
    ``multi_validator_tally`` calls it) allocates nothing larger than the
    statements broadcast over the local qsets (V, C, N), where the old
    AND-and-sum form built (V, C, K, N)."""
    v = c = n = 64
    k = 16
    orgs = [(3, list(range(o, o + 4))) for o in range(0, n, 4)]
    qt = Q.build_qset_tensor([(11, [], orgs)] * n, list(range(n)),
                             device="cpu")
    voted = torch.from_numpy(np.random.default_rng(0).random((c, n)) < 0.8)
    with _LargestTensor() as largest:
        Q.federated_accept(qt, qt, voted, voted)
    assert largest.numel <= v * c * n


# ---------------------------------------------------------------------------
# the port's native library
# ---------------------------------------------------------------------------

def test_native_library_builds_under_build_not_in_jax_package():
    jax_native = REPO / "stellar_core_tpu" / "native"
    before = {p.name: p.stat().st_mtime_ns for p in jax_native.iterdir()}
    native.get_lib()
    path = native.library_path()
    assert path.parent == REPO / "build" / "torch_native"
    assert path.exists()
    res = QI.check_quorum_intersection(clique16(LN), use_device=False)
    assert (res.ok, res.scanned, res.tier) == (True, 4003, "native")
    after = {p.name: p.stat().st_mtime_ns for p in jax_native.iterdir()}
    assert after == before


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "quorum_enum.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_device_tier_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QI.check_quorum_intersection(core4(LN), use_native=False)
    # the host tiers never resolve a device
    assert QI.check_quorum_intersection(core4(LN)).tier == "native"


# ---------------------------------------------------------------------------
# the port's quorum tracker (tests/test_quorum_tracker.py, without the sim)
# ---------------------------------------------------------------------------

def _ids(n):
    return [ref.public_from_seed(sha256(b"qt-%d" % i)) for i in range(n)]


def test_local_qset_seeds_the_closure():
    a, b, c = _ids(3)
    qt = QuorumTracker(a, LN.make_qset(2, [a, b, c]))
    assert qt.is_node_definitely_in_quorum(b)
    assert qt.is_node_definitely_in_quorum(c)
    assert not qt.is_node_definitely_in_quorum(_ids(4)[3])
    assert qt.nodes_missing_qsets() == {b, c}
    assert qt.quorum[b].distance == 1
    assert qt.quorum[b].closest_validators == {b}


def test_expand_extends_two_hops():
    a, b, c, d = _ids(4)
    qt = QuorumTracker(a, LN.make_qset(1, [a, b]))
    assert qt.expand(b, LN.make_qset(2, [c, d]))
    assert qt.is_node_definitely_in_quorum(c)
    assert qt.is_node_definitely_in_quorum(d)
    assert qt.quorum[c].distance == 2
    assert qt.quorum[c].closest_validators == {b}
    assert qt.expand(b, LN.make_qset(2, [c, d]))
    assert not qt.expand(b, LN.make_qset(1, [c]))
    e = _ids(5)[4]
    assert qt.expand(e, LN.make_qset(1, [e]))
    assert not qt.is_node_definitely_in_quorum(e)


def test_rebuild_resolves_through_lookup():
    a, b, c = _ids(3)
    qsets = {b: LN.make_qset(1, [c])}
    qt = QuorumTracker(a, LN.make_qset(1, [a, b]))
    qt.rebuild(qsets.get, LN.make_qset(1, [a, b]))
    assert qt.is_node_definitely_in_quorum(c)
    assert qt.qset_map().keys() == {a, b}
    assert qt.nodes_missing_qsets() == {c}
