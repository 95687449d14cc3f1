"""The CUDA tally kernel's block logic, checked on the host: g++ compiles
``csrc/quorum_tally.cu`` as plain C++ (one warp of one lane, the barrier a
no-op, a ballot's count a loop; the kernel and its launch left out)
through the host program ``csrc/quorum_tally_host_check.cpp``, under
AddressSanitizer and UBSan.  Its verdicts and trip counts are held
against the tally engine's plain version (the torch ops of
``ops/quorum.py`` on the CPU) and its verdicts against the host oracle
(``scp/local_node.py``).  The block runs here as one lane, so this check
cannot catch a missing or misplaced barrier, nor a read of shared memory
that another warp has not written yet: the card test
``tests/test_torch_cuda_tally.py`` runs launches back to back over
different qsets for that.

The cases (``CASES``, shared with ``tests/test_torch_cuda_tally.py``): the
public tier 1 (7 orgs x 3), ``hierarchical_quorum(10, 5)``'s qsets, a
quorum of one, chains that take N trips, and seeded random 2-level qsets
(one of 120 nodes, wider than a block's 32 warps):
"sane" ones (distinct validators, thresholds of 1 or more, some nodes
with unknown qsets), and "wild" ones with padding slots of threshold 0,
top-level thresholds of 0, duplicate validators and unknown qsets.  The
host oracle counts a duplicate validator twice and an inner set of
threshold 0 as satisfied, where the tensor form counts one member and
never counts a padding slot; stellar-core refuses such qsets as insane,
so the oracle is held only to the sane cases.  Every case runs all-false
and all-true rows and seeded rows at several densities, as accept and as
ratify.  Tolerance: exact equality."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.ops import quorum as Q
from stellar_core_tpu_torch.scp import local_node as LN
from stellar_core_tpu_torch.scp.tally import TallyEngine

CSRC = os.path.join(os.path.dirname(Q.__file__), os.pardir, "csrc")
UNKNOWN = (1, [], [])   # the engine's qset for a node it holds none for


class Case:
    """One tally setting: each node's plain qset ``(threshold, validators,
    inner_sets)`` over nodes 0..N-1, or None where the engine holds none,
    the local node (the last node with a qset), and whether the host
    oracle applies."""

    def __init__(self, name, plains, sane=True):
        self.name, self.plains, self.sane = name, plains, sane
        self.n = len(plains)
        self.local = max(i for i, p in enumerate(plains) if p is not None)

    def tensors(self, device="cpu"):
        """(local_qs, qsets) as ``TallyEngine._build`` makes them."""
        order = list(range(self.n))
        qsets = Q.build_qset_tensor(
            [UNKNOWN if p is None else p for p in self.plains], order,
            device=device)
        local_qs = Q.local_qset(Q.build_qset_tensor(
            [self.plains[self.local]], order, device=device), 0)
        return local_qs, qsets

    def draws(self, seed):
        """Accept rows (2, N): accepted, voted-or-accepted.  All false, all
        true, then seeded rows at several densities."""
        rng = np.random.default_rng(seed)
        n = self.n
        out = [np.zeros((2, n), np.bool_), np.ones((2, n), np.bool_)]
        for p in (0.3, 0.5, 0.7, 0.85, 0.95, 1.0):
            for _ in range(4):
                voted = rng.random(n) < p
                accepted = rng.random(n) < rng.uniform(0.0, p)
                out.append(np.stack([accepted, accepted | voted]))
        return out


def _org_qsets(n_orgs, per_org, top_thr, inner_thr):
    orgs = [list(range(o * per_org, (o + 1) * per_org))
            for o in range(n_orgs)]
    q = (top_thr, [], [(inner_thr, org) for org in orgs])
    return [q] * (n_orgs * per_org)


def _random_plains(rng, n, sane):
    plains = []
    for i in range(n):
        if i < n - 1 and rng.random() < 0.15:
            plains.append(None)
            continue
        k = int(rng.integers(0, 5))
        if sane:
            vals = sorted(int(v) for v in rng.choice(n, int(rng.integers(
                0, min(n, 4) + 1)), replace=False))
            inners = []
            for _ in range(k):
                iv = sorted(int(v) for v in rng.choice(
                    n, int(rng.integers(1, min(n, 6) + 1)), replace=False))
                inners.append((int(rng.integers(1, len(iv) + 1)), iv))
            top = int(rng.integers(1, max(len(vals) + len(inners), 1) + 1))
        else:
            vals = [int(v) for v in rng.integers(0, n, int(rng.integers(
                0, 6)))]
            inners = []
            for _ in range(k):
                iv = [int(v) for v in rng.integers(0, n, int(rng.integers(
                    1, 7)))]
                inners.append((int(rng.integers(0, len(iv) + 2)), iv))
            top = int(rng.integers(0, len(vals) + len(inners) + 2))
        plains.append((top, vals, inners))
    return plains


def _chain(n):
    """Node i trusts only node i + 1, the last node only itself: without
    the last node's vote the contraction drops one node a trip."""
    return [(1, [min(i + 1, n - 1)], []) for i in range(n)]


def _cases():
    cases = [Case("tier1_7x3", _org_qsets(7, 3, 5, 2)),
             Case("hierarchical_10x5", _org_qsets(10, 5, 7, 4)),
             Case("single", [(1, [0], [])]),
             Case("chain_4", _chain(4)), Case("chain_9", _chain(9))]
    for seed in range(4):
        rng = np.random.default_rng(700 + seed)
        cases.append(Case(f"random_sane_{seed}", _random_plains(
            rng, int(rng.integers(5, 31)), True)))
    # more nodes than the block has warps
    cases.append(Case("random_wide", _random_plains(
        np.random.default_rng(900), 120, True)))
    for seed in range(4):
        rng = np.random.default_rng(800 + seed)
        cases.append(Case(f"random_wild_{seed}", _random_plains(
            rng, int(rng.integers(2, 31)), False), sane=False))
    return cases


CASES = _cases()
CASE_NAMES = [c.name for c in CASES]
KINDS = ("accept", "ratify")


def case(name) -> Case:
    return next(c for c in CASES if c.name == name)


def kind_rows(kind, rows):
    """The rows a call of ``kind`` takes from an accept draw."""
    return rows if kind == "accept" else rows[1:2]


def plain_tally(kind, local_qs, qsets, rows):
    """(verdict, contraction trips) of the engine's plain version: the
    torch ops on a CPU device, trips counted at ``Q._contract_trip``."""
    engine = TallyEngine(None, "tensor", device="cpu")
    trips = []
    real = Q._contract_trip

    def counted(qs, m):
        trips.append(1)
        return real(qs, m)

    Q._contract_trip = counted
    try:
        fn = engine.device_accept if kind == "accept" else \
            engine.device_ratify
        verdict = fn(local_qs, qsets, kind_rows(kind, rows))
    finally:
        Q._contract_trip = real
    return verdict, len(trips)


def oracle_tally(c: Case, kind, rows):
    """The host oracle's verdict: ``scp/local_node.py`` on XDR qsets."""
    ids = [i.to_bytes(32, "big") for i in range(c.n)]

    def xdr(p):
        thr, vals, inners = p
        return LN.make_qset(thr, [ids[v] for v in vals], [
            LN.make_qset(t, [ids[v] for v in vs]) for t, vs in inners])

    qsets = {ids[i]: xdr(p) for i, p in enumerate(c.plains) if p is not None}
    local = qsets[ids[c.local]]
    rows = kind_rows(kind, rows)
    if kind == "accept" and LN.is_v_blocking(
            local, {ids[i] for i in np.flatnonzero(rows[0])}):
        return True
    return LN.is_quorum({ids[i] for i in np.flatnonzero(rows[-1])},
                        qsets.get, local_qset=local)


def host_line(local_qs, qsets, rows) -> str:
    """One input line of the host program."""
    n = qsets.top_mem.shape[-1]
    parts = [n, qsets.inner_thr.shape[-1], local_qs.inner_thr.shape[-1],
             rows.shape[0]]
    for t in (*qsets, *local_qs):
        parts += t.to(torch.int32).reshape(-1).tolist()
    parts += rows.astype(np.int32).reshape(-1).tolist()
    return " ".join(map(str, parts))


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """Compile the host program once; returns run(lines) -> (verdict,
    trips) a line."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source as host C++")
    exe = tmp_path_factory.mktemp("quorum_tally_host") / "host_check"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-I", CSRC, os.path.join(CSRC, "quorum_tally_host_check.cpp"),
         "-o", str(exe)], check=True, capture_output=True, text=True)

    def run(lines):
        res = subprocess.run(
            [str(exe)], input="\n".join(lines) + "\n", capture_output=True,
            text=True, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
        assert res.returncode == 0, res.stderr
        out = [tuple(int(x) for x in ln.split()) for ln in
               res.stdout.splitlines()]
        assert len(out) == len(lines) and all(len(o) == 2 for o in out)
        return out

    return run


@pytest.mark.parametrize("draw", [0, 1], ids=["rows0", "rows1"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_block_equals_plain_version(host_check, name, draw):
    """Verdicts and trips of the block logic = the torch ops', accept and
    ratify, on every row of two seeded draws; the case decides both ways
    somewhere."""
    c = case(name)
    local_qs, qsets = c.tensors()
    calls = [(kind, rows) for rows in c.draws(seed=len(name) + 1000 * draw)
             for kind in KINDS]
    got = host_check([host_line(local_qs, qsets, kind_rows(kind, rows))
                      for kind, rows in calls])
    verdicts = set()
    for (kind, rows), (verdict, trips) in zip(calls, got):
        want, want_trips = plain_tally(kind, local_qs, qsets, rows)
        assert bool(verdict) == want, (kind, rows)
        vblock = kind == "accept" and bool(
            Q.is_v_blocking(local_qs, torch.from_numpy(rows[0:1]))[0])
        assert trips == (0 if vblock else want_trips), (kind, rows)
        verdicts.add(want)
    assert verdicts == {False, True}


@pytest.mark.parametrize("name", [c.name for c in CASES if c.sane])
def test_block_equals_host_oracle(host_check, name):
    c = case(name)
    local_qs, qsets = c.tensors()
    calls = [(kind, rows) for rows in c.draws(seed=1 + len(name))
             for kind in KINDS]
    got = host_check([host_line(local_qs, qsets, kind_rows(kind, rows))
                      for kind, rows in calls])
    for (kind, rows), (verdict, _) in zip(calls, got):
        assert bool(verdict) == oracle_tally(c, kind, rows), (kind, rows)


@pytest.mark.parametrize("n", [4, 9])
def test_chain_takes_n_trips(host_check, n):
    """Without the last node's vote the chain unravels one node a trip:
    N - 1 trips that drop a node and one that finds nothing to drop."""
    local_qs, qsets = case(f"chain_{n}").tensors()
    voted = np.array([[True] * (n - 1) + [False]])
    (verdict, trips), = host_check([host_line(local_qs, qsets, voted)])
    assert (verdict, trips) == (0, n)
    assert plain_tally("ratify", local_qs, qsets, np.vstack([voted] * 2)) \
        == (False, n)


def test_vblocking_accept_runs_no_trip(host_check):
    """An accepted set that blocks the local qset decides the accept
    before any contraction; with the vote row alone (ratify) it takes
    its trips."""
    local_qs, qsets = case("tier1_7x3").tensors()
    accepted = np.zeros(21, np.bool_)
    accepted[[0, 1, 3, 4, 6, 7]] = True     # 2 of 3 in 3 of 7 orgs: blocks
    rows = np.stack([accepted, accepted])
    out = host_check([host_line(local_qs, qsets, rows),
                      host_line(local_qs, qsets, rows[1:])])
    assert out == [(1, 0), (0, 2)]
