"""Simulation: N full Applications in one process sharing a VirtualClock,
wired over loopback links — whole consensus networks run deterministically
at accelerated time (ref src/simulation/Simulation.h:29, Topologies.h;
SURVEY.md §4.2: "how multi-node is tested without a cluster").

This harness is also the multi-validator device driver: every node runs
its device tiers (each crank's SCP envelope batch and each close's
signature batch on the ``cuda`` crypto backend, the tallies on
``tensor``/``both``) on the one device the simulation was given — the GPU
unless ``device`` names another, and with no GPU and no ``device`` a node
on a device backend refuses to start (SURVEY.md §2.17 P4).

Chaos support (simulation/chaos.py drives these seams):
- every loopback link is registered in ``links`` so fault injection can
  find both directions of any pair;
- nodes may run with on-disk state (``node_dir``) so ``crash_node`` /
  ``restart_node`` model a full process kill + restart-from-state;
- ``header_chain`` / ``assert_no_forks`` are the safety oracle: honest
  survivors must agree on every closed header (bucket hash included).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto import SecretKey, sha256
from ..main.application import Application
from ..main.config import Config
from ..overlay.manager import OverlayManager
from ..overlay.peer import make_loopback_pair
from ..utils.clock import ClockMode, VirtualClock
from ..xdr import types as T, xdr_sha256


class Simulation:
    OVER_LOOPBACK = 0

    def __init__(self, mode: int = OVER_LOOPBACK,
                 network_passphrase: str = "test simulation network",
                 device=None):
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        self.network_passphrase = network_passphrase
        # every node's device (Application(device=...)), restarts included
        self.device = device
        self.nodes: Dict[bytes, Application] = {}
        self.node_seeds: Dict[bytes, bytes] = {}
        # rebuild recipes for restart-from-state (chaos kill-restore)
        self.node_recipes: Dict[bytes, dict] = {}
        # intended adjacency (survives crashes; restart re-wires from it)
        self.topology: List[Tuple[bytes, bytes]] = []
        # live loopback pairs: (a, b) -> (peer at a, peer at b)
        self.links: Dict[Tuple[bytes, bytes], tuple] = {}
        self.crashed: Dict[bytes, bool] = {}
        # network observatory (attach_observatory); restart_node
        # re-attaches it to rebuilt Applications
        self.observatory = None

    # -- topology construction ---------------------------------------------

    def add_node(self, seed: bytes, qset_spec: dict,
                 node_dir: Optional[str] = None,
                 **config_kw) -> Application:
        """qset_spec: {"threshold": t, "validators": [node ids],
        "inner_sets": [...]}.  ``node_dir`` gives the node on-disk state
        (SQLite DB + bucket store) so it can be killed and restarted
        from state by the chaos engine."""
        recipe = {"seed": seed, "qset_spec": qset_spec,
                  "node_dir": node_dir, "config_kw": dict(config_kw)}
        cfg = self._build_config(recipe)
        app = self._build_app(cfg)
        self.nodes[cfg.node_id()] = app
        self.node_seeds[cfg.node_id()] = seed
        self.node_recipes[cfg.node_id()] = recipe
        return app

    def _build_config(self, recipe: dict) -> Config:
        config_kw = dict(recipe["config_kw"])
        node_dir = recipe["node_dir"]
        if node_dir is not None:
            os.makedirs(os.path.join(node_dir, "buckets"), exist_ok=True)
            config_kw.setdefault(
                "DATABASE", os.path.join(node_dir, "node.db"))
            config_kw.setdefault(
                "BUCKET_DIR_PATH_REAL", os.path.join(node_dir, "buckets"))
        # sims default the close pipeline OFF: a 50-validator network
        # in one process would own 50 tail workers for no modelled
        # benefit, and the scripted chaos wall-cost budget predates it.
        # Pipeline-specific sim tests (the chaos pipeline-window
        # kill-restore) opt in per node via config_kw, and the core-4
        # chaos smoke tier runs PIPELINED_CLOSE=True wholesale
        # (tools/chaos_bench.py) so the overlap contract is
        # chaos-tested.
        config_kw.setdefault("PIPELINED_CLOSE", False)
        # no per-node 1 Hz vitals timers at simulation scale (50 nodes
        # = 50 timers per virtual second); vitals tests opt in
        config_kw.setdefault("VITALS_ENABLED", False)
        return Config(
            NETWORK_PASSPHRASE=self.network_passphrase,
            NODE_SEED=recipe["seed"],
            QUORUM_SET=recipe["qset_spec"],
            RUN_STANDALONE=False,
            MANUAL_CLOSE=config_kw.pop("MANUAL_CLOSE", True),
            ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING=True,
            INVARIANT_CHECKS=config_kw.pop("INVARIANT_CHECKS", [".*"]),
            # sim topologies use deliberately small/unsafe quorums
            # (ref getTestConfig setting UNSAFE_QUORUM)
            UNSAFE_QUORUM=config_kw.pop("UNSAFE_QUORUM", True),
            **config_kw,
        )

    def _build_app(self, cfg: Config) -> Application:
        app = Application(self.clock, cfg, self.device)
        app.overlay_manager = OverlayManager(app)
        if self.observatory is not None:
            app._observatory = self.observatory
        return app

    def add_connection(self, a: bytes, b: bytes) -> None:
        if (a, b) not in self.topology and (b, a) not in self.topology:
            self.topology.append((a, b))
        self._wire(a, b)

    def _wire(self, a: bytes, b: bytes) -> None:
        p1, p2 = make_loopback_pair(self.nodes[a], self.nodes[b])
        self.links[(a, b)] = (p1, p2)

    def link_peers(self, a: bytes, b: bytes) -> list:
        """Both LoopbackPeer ends of the (a, b) link, either key order."""
        pair = self.links.get((a, b)) or self.links.get((b, a))
        return list(pair) if pair is not None else []

    def start_all_nodes(self) -> None:
        for app in self.nodes.values():
            app.start()

    # -- crash / restart (the chaos kill-restore seam) -----------------------

    def crash_node(self, node_id: bytes) -> None:
        """Kill one validator mid-flight: close its links (both ends),
        tear down its subsystems, cancel its timers on the shared clock.
        On-disk state survives for ``restart_node``."""
        app = self.nodes[node_id]
        for key in [k for k in self.links if node_id in k]:
            p_a, p_b = self.links.pop(key)
            for p in (p_a, p_b):
                if p.app is not app:
                    p.close("peer crashed")
        app.stop_node()
        self.crashed[node_id] = True

    def restart_node(self, node_id: bytes) -> Application:
        """Rebuild the crashed node from its on-disk state (the
        restart-from-state path: load-last-known-ledger, hash-verified
        bucket restore, SCP state re-ingest) and re-wire its topology
        links to the surviving nodes."""
        recipe = self.node_recipes[node_id]
        assert recipe["node_dir"] is not None, \
            "restart_node needs a node_dir-backed node"
        app = self._build_app(self._build_config(recipe))
        self.nodes[node_id] = app
        self.crashed.pop(node_id, None)
        app.start()
        for a, b in self.topology:
            if node_id not in (a, b):
                continue
            other = b if a == node_id else a
            if self.crashed.get(other) or other not in self.nodes:
                continue
            self._wire(a, b)
        return app

    def alive_nodes(self) -> Dict[bytes, Application]:
        return {nid: app for nid, app in self.nodes.items()
                if not self.crashed.get(nid)}

    # -- observability rigs ---------------------------------------------------

    def attach_observatory(self):
        """Create (or return) the fleet-level NetworkObservatory and hang
        it off every node as ``app._observatory`` so each node's
        ``network-observatory`` admin endpoint serves the merged view.
        Nodes rebuilt by ``restart_node`` re-attach automatically."""
        if self.observatory is None:
            from .observatory import NetworkObservatory

            self.observatory = NetworkObservatory(self)
        for app in self.nodes.values():
            app._observatory = self.observatory
        return self.observatory

    def enable_crank_profiler(self):
        """Arm the shared clock's wall-attribution profiler (fresh run:
        re-enabling restarts the measurement window)."""
        from ..utils.clock import CrankProfiler

        self.clock.profiler = CrankProfiler()
        self._profiler_v0 = self.clock.now()
        return self.clock.profiler

    def crank_report(self) -> Optional[dict]:
        """The profiler's bucket report over the window since
        ``enable_crank_profiler``, with wall-per-virtual-second."""
        prof = self.clock.profiler
        if prof is None:
            return None
        return prof.report(
            virtual_elapsed=self.clock.now() - self._profiler_v0)

    # -- driving ------------------------------------------------------------

    def crank(self, block: bool = False) -> int:
        return self.clock.crank(block)

    def crank_until(self, pred: Callable[[], bool],
                    timeout: float = 100.0) -> bool:
        return self.clock.crank_until(pred, timeout)

    def crank_for(self, seconds: float) -> None:
        deadline = self.clock.now() + seconds
        while self.clock.now() < deadline:
            if self.clock.crank(block=True) == 0 and \
                    self.clock.next_deadline() is None:
                break

    def have_all_externalized(self, seq: int) -> bool:
        return all(
            app.ledger_manager.last_closed_seq() >= seq
            for app in self.alive_nodes().values())

    def trigger_all(self) -> None:
        """Manual-close mode: every validator proposes for the next slot."""
        for app in self.alive_nodes().values():
            app.herder.trigger_next_ledger()

    def close_ledger(self, timeout: float = 60.0) -> bool:
        """One consensus round across the whole network."""
        target = max(app.ledger_manager.last_closed_seq()
                     for app in self.alive_nodes().values()) + 1
        self.trigger_all()
        return self.crank_until(
            lambda: self.have_all_externalized(target), timeout)

    # -- assertions ----------------------------------------------------------

    def ledger_hashes(self, seq: Optional[int] = None) -> List[bytes]:
        return [app.ledger_manager.last_closed_hash()
                for app in self.alive_nodes().values()]

    def assert_in_sync(self) -> None:
        hashes = self.ledger_hashes()
        assert len(set(hashes)) == 1, [h.hex()[:8] for h in hashes]

    def header_chain(self, node_id: bytes) -> Dict[int, tuple]:
        """seq -> (header hash, bucketListHash) for every ledger the node
        has closed, read from its persisted header rows — the fork
        oracle's raw material."""
        return app_header_chain(self.nodes[node_id])

    def assert_no_forks(self, node_ids: Optional[List[bytes]] = None
                        ) -> int:
        """Every pair of (honest, alive) nodes must agree on the header
        hash AND bucket-list hash of every ledger seq both have closed.
        Returns the number of (seq) comparisons made; raises
        AssertionError on the first divergence — a fork."""
        if node_ids is None:
            node_ids = list(self.alive_nodes())
        chains = {nid: self.header_chain(nid) for nid in node_ids}
        compared = 0
        ids = list(chains)
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                a, b = ids[i], ids[j]
                for seq in chains[a].keys() & chains[b].keys():
                    ha, ba = chains[a][seq]
                    hb, bb = chains[b][seq]
                    assert ha == hb, (
                        f"FORK: header divergence at seq {seq} between "
                        f"{a.hex()[:8]} ({ha.hex()[:8]}) and "
                        f"{b.hex()[:8]} ({hb.hex()[:8]})")
                    assert ba == bb, (
                        f"FORK: bucket-hash divergence at seq {seq} "
                        f"between {a.hex()[:8]} and {b.hex()[:8]}")
                    compared += 1
        return compared


# -- canned topologies (ref src/simulation/Topologies.h:12-80) ---------------

def _seeds(n: int) -> List[bytes]:
    return [sha256(b"sim-node-%d" % i) for i in range(n)]


def _ids(seeds: List[bytes]) -> List[bytes]:
    return [SecretKey(s).public_key().raw for s in seeds]


def _node_dir(base: Optional[str], i: int) -> Optional[str]:
    return None if base is None else os.path.join(base, f"node{i:03d}")


def app_header_chain(app: Application) -> Dict[int, tuple]:
    """``Simulation.header_chain`` of any node, in a simulation or not."""
    out: Dict[int, tuple] = {}
    for seq, data in app.database.execute(
            "SELECT ledgerseq, data FROM ledgerheaders "
            "ORDER BY ledgerseq").fetchall():
        hdr = T.LedgerHeader.decode(data)
        out[seq] = (xdr_sha256(T.LedgerHeader, hdr), hdr.bucketListHash)
    return out


def core(n: int, threshold: Optional[int] = None,
         passphrase: str = "test simulation network",
         persist_dir: Optional[str] = None, device=None,
         **config_kw) -> Simulation:
    """Fully-connected core-N: every validator trusts all N with the given
    threshold (default 2f+1; ref Topologies::core)."""
    sim = Simulation(network_passphrase=passphrase, device=device)
    seeds = _seeds(n)
    ids = _ids(seeds)
    thr = threshold if threshold is not None else n - (n - 1) // 3
    qset = {"threshold": thr, "validators": ids}
    for i, s in enumerate(seeds):
        sim.add_node(s, qset, node_dir=_node_dir(persist_dir, i),
                     **config_kw)
    for i in range(n):
        for j in range(i + 1, n):
            sim.add_connection(ids[i], ids[j])
    return sim


def pair(passphrase: str = "test simulation network",
         device=None) -> Simulation:
    return core(2, threshold=2, passphrase=passphrase, device=device)


def cycle(n: int, passphrase: str = "test simulation network",
          device=None) -> Simulation:
    """Ring: each node trusts itself + both neighbors (2-of-3)."""
    sim = Simulation(network_passphrase=passphrase, device=device)
    seeds = _seeds(n)
    ids = _ids(seeds)
    for i, s in enumerate(seeds):
        neighbors = [ids[i], ids[(i - 1) % n], ids[(i + 1) % n]]
        sim.add_node(s, {"threshold": 2, "validators": neighbors})
    for i in range(n):
        sim.add_connection(ids[i], ids[(i + 1) % n])
    return sim


def hierarchical_quorum(n_orgs: int, per_org: int = 5,
                        passphrase: str = "test simulation network",
                        persist_dir: Optional[str] = None, device=None,
                        **config_kw) -> Simulation:
    """Tiered/org topology (ref Topologies::hierarchicalQuorum): the
    network is ``n_orgs`` organizations of ``per_org`` validators each.

    Quorum structure (same symmetric qset on every validator): the
    top level requires a byzantine-safe majority of ORGS (inner sets),
    each org an internal 2f+1 of its members — the two-tier shape real
    networks (and the reference's hierarchicalQuorum) use.

    Connectivity is deliberately sparser than core-N so partitions mean
    something: full mesh inside each org, a full mesh between org
    leaders (member 0), plus each org's member 1 linked to the NEXT
    org's leader so losing one leader cannot isolate an org.
    """
    assert n_orgs >= 2 and per_org >= 1
    n = n_orgs * per_org
    sim = Simulation(network_passphrase=passphrase, device=device)
    seeds = _seeds(n)
    ids = _ids(seeds)
    orgs = [ids[o * per_org:(o + 1) * per_org] for o in range(n_orgs)]
    org_sets = [
        {"threshold": per_org - (per_org - 1) // 3, "validators": members}
        for members in orgs]
    qset = {"threshold": n_orgs - (n_orgs - 1) // 3,
            "validators": [], "inner_sets": org_sets}
    for i, s in enumerate(seeds):
        sim.add_node(s, qset, node_dir=_node_dir(persist_dir, i),
                     **config_kw)
    for o, members in enumerate(orgs):
        for i in range(per_org):
            for j in range(i + 1, per_org):
                sim.add_connection(members[i], members[j])
        next_org = orgs[(o + 1) % n_orgs]
        if per_org >= 2:
            sim.add_connection(members[1], next_org[0])
    leaders = [members[0] for members in orgs]
    for i in range(n_orgs):
        for j in range(i + 1, n_orgs):
            sim.add_connection(leaders[i], leaders[j])
    return sim
