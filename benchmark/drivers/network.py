"""A network of validators in one process, one network ledger a step.

Set-up builds the deployment with the port's ``Simulation`` on the card:
every validator with its own database and buckets on disk and the quorum
set that stellar-core's automatic quorum generation gives organisations
of validators of high quality (``quorum_set``).  It starts every node and
lets the network settle, closes a ledger in which the root creates the seeded
accounts, and runs the warm-up ledgers of the cell's own traffic, so that
the tallies, the overlay's batches and the close's verify have run at
the cell's shapes before the window opens at the same ledger every run.
It also makes the payments of the workload's ``pool_ledgers`` window
ledgers; a window that outruns them stops the run.

A step is one network ledger: the ledger's payments, decoded from their
wire bytes and handed round-robin to the validators'
``herder.recv_transaction``, with the network cranked until the flood is
quiet (span ``submit``), then ``Simulation.close_ledger``: every
validator proposes and the network is cranked until all have
externalized (span ``crank``).  In a traced run the benchmark also arms
the clock's ``CrankProfiler`` and times the tally engine's federated
calls and the overlay's envelope batches by wrapping them.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

from .. import node
from ..traffic import Traffic


def quorum_set(orgs: list[list[bytes]]) -> dict:
    """The quorum set of stellar-core's ``Config::generateQuorumSet`` for
    organisations of high quality (``computeDefaultThreshold``): each
    organisation an inner set at a simple majority of its validators,
    the top level at the byzantine threshold 1 + 2n/3 of n organisations."""
    return {"threshold": 1 + 2 * len(orgs) // 3, "validators": [],
            "inner_sets": [{"threshold": len(m) // 2 + 1, "validators": m}
                           for m in orgs]}


def links(orgs: list[list[bytes]]) -> list[tuple[bytes, bytes]]:
    """A full mesh in each organisation and between the organisations'
    first validators, and each organisation's second validator to the
    next organisation's first."""
    out = [(m[a], m[b]) for m in orgs
           for a in range(len(m)) for b in range(a + 1, len(m))]
    out += [(m[1], orgs[(o + 1) % len(orgs)][0])
            for o, m in enumerate(orgs) if len(m) > 1]
    leads = [m[0] for m in orgs]
    out += [(leads[a], leads[b]) for a in range(len(leads))
            for b in range(a + 1, len(leads))]
    return out


def setup(ctx):
    import hashlib
    import os

    from stellar_core_tpu_torch.crypto import SecretKey
    from stellar_core_tpu_torch.simulation import Simulation

    cfg, wl = ctx.config, ctx.workload
    node.use_port_defaults(cfg["port_defaults"])
    tmp = node.scratch_dir("network")
    topo = cfg["topology"]
    n = topo["orgs"] * topo["per_org"]
    seeds = [hashlib.sha256(b"benchmark-validator-%d" % k).digest()
             for k in range(n)]
    ids = [SecretKey(s).public_key().raw for s in seeds]
    orgs = [ids[o:o + topo["per_org"]] for o in range(0, n, topo["per_org"])]
    qset = quorum_set(orgs)
    sim = Simulation(network_passphrase=cfg["passphrase"], device=ctx.device)
    for k, s in enumerate(seeds):
        sim.add_node(s, qset, **node.node_settings(
            cfg, os.path.join(tmp, f"node{k:02d}")))
    for a, b in links(orgs):
        sim.add_connection(a, b)
    apps = list(sim.nodes.values())
    sim.start_all_nodes()
    node.settle(sim)
    st = SimpleNamespace(sim=sim, apps=apps, tmp=tmp, records=[],
                         envs=None, statuses=None)
    st.traffic = Traffic(ctx.seed, cfg["passphrase"], cfg["accounts"],
                         wl["balance"], wl["amount_max"])
    _ledger(ctx, st, st.traffic.create_accounts(node.GENESIS_ROOT_SEQ), False)
    created = node.GENESIS_SEQ + 1
    st.next_seq = [(created << 32) + 1] * st.traffic.n_accounts
    for _ in range(wl["warmup_ledgers"]):
        _ledger(ctx, st, _payments(ctx, st), False)
    st.pool = [_payments(ctx, st) for _ in range(wl["pool_ledgers"])]
    return st


def _payments(ctx, st):
    wl = ctx.workload
    return st.traffic.ledger(st.next_seq, wl["per_ledger"],
                             wl["forged_per_ledger"])


def _submit(st, envs) -> list[int]:
    apps = st.apps
    out = [apps[k % len(apps)].herder.recv_transaction(
        node.decode_envelope(e.wire)) for k, e in enumerate(envs)]
    node.settle(st.sim)
    return out


def _close(ctx, st) -> bool:
    ok = st.sim.close_ledger(timeout=ctx.workload["close_timeout_virtual_s"])
    ctx.sync()
    return ok


def _ledger(ctx, st, envs, in_window) -> None:
    statuses = _submit(st, envs)
    _close(ctx, st)
    _record(st, envs, statuses, in_window)


def _record(st, envs, statuses, in_window) -> None:
    closed = [app.ledger_manager.last_closed_seq() for app in st.apps]
    st.records.append((envs, statuses, closed, in_window))


class _Timed:
    """Wraps ``owner.<name>`` for the window: calls and seconds."""

    def __init__(self, owner, names):
        self.owner, self.names = owner, names
        self.calls, self.seconds, self.saved = 0, 0.0, {}

    def install(self):
        for name in self.names:
            real = self.saved[name] = getattr(self.owner, name)
            setattr(self.owner, name, self._wrap(real))

    def _wrap(self, real):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return timed

    def remove(self):
        for name, real in self.saved.items():
            setattr(self.owner, name, real)


def window_open(ctx, st) -> None:
    st.probes = []
    if ctx.trace:
        from stellar_core_tpu_torch.overlay.manager import OverlayManager
        from stellar_core_tpu_torch.scp.tally import TallyEngine

        st.tally = _Timed(TallyEngine, ("federated_accept",
                                        "federated_ratify"))
        st.overlay = _Timed(OverlayManager, ("_verify_triples",))
        st.probes = [st.tally, st.overlay]
        for p in st.probes:
            p.install()
        st.sim.enable_crank_profiler()


def prepare(ctx, st, i) -> None:
    st.envs = node.from_pool(st.pool, i)


def step(ctx, st, i) -> None:
    with ctx.span("submit"):
        st.statuses = _submit(st, st.envs)
    with ctx.span("crank"):
        _close(ctx, st)


def after(ctx, st, i) -> None:
    _record(st, st.envs, st.statuses, True)
    ctx.attempted += len(st.envs)


def window_close(ctx, st) -> None:
    for p in st.probes:
        p.remove()
    if ctx.trace:
        ctx.counters.update(
            crank_report=st.sim.crank_report(),
            tally_s=st.tally.seconds, tally_calls=st.tally.calls,
            overlay_verify_s=st.overlay.seconds)
        st.sim.clock.profiler = None


def collect(ctx, st) -> dict:
    from stellar_core_tpu_torch.simulation.simulation import app_header_chain

    pubs = st.traffic.keys.public
    out = {"records": st.records, "pubs": pubs, "nodes": []}
    for app in st.apps:
        out["nodes"].append({
            "history": node.history(app),
            "accounts": node.accounts(app, pubs),
            "root_seq": node.accounts(app, [st.traffic.root_pub])[0][1],
            "chain": {seq: h for seq, (h, _) in app_header_chain(app).items()},
        })
    for app in st.apps:
        app.stop_node()
    st.sim.clock.stop()
    node.release(st.tmp)
    return out


def judge(ctx, out) -> dict:
    """Every validator against the plain reference: admission at the node
    each envelope was submitted to, the ledger every node closed after
    each step, one header hash a sequence on all nodes, each node's
    applied set with results and fees, and each node's accounts."""
    model, statuses_wrong, ledgers_wrong, window_failed, last = node.replay(
        out["records"], len(out["pubs"]))
    chains = [n["chain"] for n in out["nodes"]]
    ledgers_split = sum(
        len({c.get(s) for c in chains}) != 1 or chains[0].get(s) is None
        for s in range(node.GENESIS_SEQ + 1, last + 1))
    results_wrong = accounts_wrong = 0
    for n in out["nodes"]:
        results_wrong += node.compare_history(model, n["history"])
        accounts_wrong += node.compare_accounts(model, n["accounts"],
                                                out["pubs"])
        accounts_wrong += n["root_seq"] != model.root_seq
    window_envs = [e for envs, _, _, w in out["records"] if w for e in envs]
    ctx.failed = window_failed + results_wrong
    return {
        "statuses_wrong": (statuses_wrong, 0),
        "results_wrong": (results_wrong, 0),
        "accounts_wrong": (accounts_wrong, 0),
        "ledgers_wrong": (ledgers_wrong, 0),
        "ledgers_split": (ledgers_split, 0),
        "reference_disagrees": (node.sample_disagrees(
            window_envs, ctx.seed, ctx.workload["sample_per_kind"]), 0),
    }
