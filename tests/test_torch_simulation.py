"""The port's simulated networks held against the JAX package's, in one
process.  The port's nodes run the ``cpu`` crypto backend with ``both``
tallies on ``device="cpu"`` (every tally on the torch ops, held to the host
oracle: a mismatch raises); the JAX nodes run their host tiers.

1. The canned builders (``core``, ``pair``, ``cycle``,
   ``hierarchical_quorum`` up to 7 x 3) build the JAX builders' networks,
   every node on the simulation's device.  core-4, cycle-6 (built node
   by node: ``cycle`` takes no backends), ``hierarchical_quorum(3, 3)`` and
   the 3 orgs x 2 of ``tests/test_scp_tensor_tally.py``: the same seeds
   and the same
   transactions (the root creates accounts in ledger 2, payments go
   round-robin to the nodes in ledger 3, ledger 4 is empty) give, node by
   node and ledger by ledger, the same header hash and externalized
   ``StellarValue`` in both packages, and the same envelope-batch counts;
   the port's tensor tallies engage with no host fallback.
2. A crashed node does not stop the quorum; ``restart_node`` rebuilds a
   node from its ``node_dir`` on the simulation's device and it closes with
   the rest.
3. With no GPU, a network on the default backends and no ``device``
   raises; it never runs quietly on the CPU.
4. ``chip_smoke.run_network`` (the card's ``network`` phase) at 3 x 3:
   the same hashes with ``both`` tallies and on the host tiers, the forged
   envelope refused, no launch on the ``cpu`` backend.

Tolerance: exact (bytes, hashes, counts).
"""
import pytest
import torch

import stellar_core_tpu.simulation as J
import stellar_core_tpu_torch.simulation as PORT
from stellar_core_tpu.simulation.simulation import Simulation as JSimulation
from stellar_core_tpu.utils import device as jax_device
from stellar_core_tpu.xdr import types as JT
from chip_smoke import Account, run_network, settle
from stellar_core_tpu_torch.simulation import (core, cycle,
                                               hierarchical_quorum, pair)
from stellar_core_tpu_torch.simulation.simulation import (Simulation, _ids,
                                                          _seeds)
from stellar_core_tpu_torch.xdr import types as T

HOST = {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "both"}
N_ACCOUNTS = 12


@pytest.fixture(autouse=True)
def jax_host_tiers(monkeypatch):
    """The JAX nodes resolve ``auto`` to their host tiers, never through a
    device probe that could answer differently from run to run."""
    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)


@pytest.fixture(autouse=True)
def traces_in_tmp_path(tmp_path, monkeypatch):
    """A node's slow-close traces go to its ``TRACE_DIR``, ``traces`` in the
    cwd by default: every network this file builds (the executed cases'
    too) writes them under the test's own directory, never the checkout."""
    monkeypatch.chdir(tmp_path)


def ring(sim_cls, n=6, **kw):
    """``cycle(n)``'s network with the node keywords ``cycle`` does not
    take: each node trusts itself and both neighbours (2 of 3)."""
    sim = sim_cls(**kw)
    ids = _ids(_seeds(n))
    for i, s in enumerate(_seeds(n)):
        sim.add_node(s, {"threshold": 2, "validators": [
            ids[i], ids[(i - 1) % n], ids[(i + 1) % n]]},
            **(HOST if sim_cls is Simulation else {}))
    for i in range(n):
        sim.add_connection(ids[i], ids[(i + 1) % n])
    return sim


def orgs_3x2(sim_cls, **kw):
    """``tests/test_scp_tensor_tally.py``'s 2-level network: 3 orgs of 2,
    2 of 3 orgs, each org 2 of 2, fully connected."""
    sim = sim_cls(network_passphrase="tensor tally net", **kw)
    ids = _ids(_seeds(6))
    qset = {"threshold": 2, "validators": [], "inner_sets": [
        {"threshold": 2, "validators": ids[i:i + 2]} for i in (0, 2, 4)]}
    for s in _seeds(6):
        sim.add_node(s, qset, **(HOST if sim_cls is Simulation else {}))
    for i in range(6):
        for j in range(i + 1, 6):
            sim.add_connection(ids[i], ids[j])
    return sim


TOPOLOGIES = {
    "core4": (lambda: core(4, device="cpu", **HOST), lambda: J.core(4)),
    "cycle6": (lambda: ring(Simulation, device="cpu"),
               lambda: ring(JSimulation)),
    "hierarchical3x3": (
        lambda: hierarchical_quorum(3, 3, device="cpu", **HOST),
        lambda: J.hierarchical_quorum(3, 3)),
    "orgs3x2": (lambda: orgs_3x2(Simulation, device="cpu"),
                lambda: orgs_3x2(JSimulation)),
}


def externalized(sim, types, seq):
    """(header hash, externalized StellarValue bytes) of ledger ``seq`` on
    every node, in node order."""
    out = []
    for nid in sim.nodes:
        header_hash, _ = sim.header_chain(nid)[seq]
        data = sim.nodes[nid].database.execute(
            "SELECT data FROM ledgerheaders WHERE ledgerseq=?",
            (seq,)).fetchone()[0]
        out.append((header_hash, types.StellarValue.encode(
            types.LedgerHeader.decode(data).scpValue)))
    return out


def traffic(app):
    """Envelope bytes of each ledger: the root creates ``N_ACCOUNTS``
    accounts; each pays the next; nothing."""
    root = Account.root(app)
    accounts = [Account.named(app, b"sim-account-%d" % i)
                for i in range(N_ACCOUNTS)]
    create = root.tx([root.op_create_account(a.account_id, 10**10)
                      for a in accounts])
    seq = (2 << 32) + 1   # the first of an account created in ledger 2
    pays = [a.tx([a.op_payment(accounts[(i + 1) % N_ACCOUNTS].account_id,
                               1 + i)], seq=seq)
            for i, a in enumerate(accounts)]
    return [[T.TransactionEnvelope.encode(create)],
            [T.TransactionEnvelope.encode(e) for e in pays], []]


def run(sim, types, ledgers):
    """Start ``sim``, submit each ledger's envelopes round-robin to the
    nodes, flood, close, and check that every node applied every
    transaction with success (``txSUCCESS`` is 0); per ledger the nodes'
    ``externalized`` values, and the nodes' envelope-batch counts."""
    sim.start_all_nodes()
    settle(sim)
    apps = list(sim.nodes.values())
    out = []
    for envs in ledgers:
        for i, blob in enumerate(envs):
            assert apps[i % len(apps)].herder.recv_transaction(
                types.TransactionEnvelope.decode(blob)) == 0
        settle(sim)
        seq = apps[0].ledger_manager.last_closed_seq() + 1
        assert sim.close_ledger(timeout=200)
        sim.assert_in_sync()
        for app in apps:   # every transaction applied, and succeeded
            rows = app.database.execute(
                "SELECT txresult FROM txhistory WHERE ledgerseq=?",
                (seq,)).fetchall()
            assert [types.TransactionResultPair.decode(r).result.result.type
                    for r, in rows] == [0] * len(envs)
        out.append(externalized(sim, types, seq))
    counts = [(app.metrics.counter("overlay.sigbatch.batches").count,
               app.metrics.counter("overlay.sigbatch.envelopes").count)
              for app in apps]
    return out, counts


def tally_stats(sim):
    engines = [s.tally for app in sim.nodes.values()
               for s in app.herder.scp.slots.values() if s.tally is not None]
    return (sum(e.tensor_tallies for e in engines),
            sum(e.host_fallbacks for e in engines))


@pytest.mark.parametrize("build", [
    lambda m, d: m.core(4, **d), lambda m, d: m.pair(**d),
    lambda m, d: m.cycle(6, **d),
    lambda m, d: m.hierarchical_quorum(3, 3, **d),
    lambda m, d: m.hierarchical_quorum(7, 3, **d),
], ids=["core4", "pair", "cycle6", "hierarchical3x3", "hierarchical7x3"])
def test_builders_equal_jax(build):
    """The port's canned topologies build the JAX builders' networks (the
    same seeds, quorum sets, node configs and links), every node on the
    simulation's device with ``auto`` resolved to the device tiers."""
    port, jax = build(PORT, {"device": "cpu"}), build(J, {})
    assert port.device == "cpu"
    assert port.node_recipes == jax.node_recipes
    assert port.topology == jax.topology
    for app in port.nodes.values():
        assert app.device == torch.device("cpu")
        assert (app.config.CRYPTO_BACKEND,
                app.config.SCP_TALLY_BACKEND) == ("cuda", "tensor")


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_network_equals_jax(name):
    make_port, make_jax = TOPOLOGIES[name]
    port = make_port()
    ledgers = traffic(next(iter(port.nodes.values())))
    got, counts = run(port, T, ledgers)
    jax = make_jax()
    assert all(app.config.CRYPTO_BACKEND == "cpu" for app in
               jax.nodes.values())
    want, jcounts = run(jax, JT, ledgers)
    assert got == want
    assert counts == jcounts and all(b > 0 for b, _ in counts)
    assert len({h for ledger in got for h, _ in ledger}) == len(ledgers)
    tallies, fallbacks = tally_stats(port)
    assert tallies > 0 and fallbacks == 0


def test_node_crash_quorum_still_closes():
    sim = core(4, device="cpu", **HOST)
    sim.start_all_nodes()
    settle(sim)
    apps = list(sim.nodes.values())
    apps[3].overlay_manager.shutdown()
    settle(sim)
    live = apps[:3]
    target = max(a.ledger_manager.last_closed_seq() for a in live) + 1
    for a in live:
        a.herder.trigger_next_ledger()
    assert sim.crank_until(
        lambda: all(a.ledger_manager.last_closed_seq() >= target
                    for a in live), 120)
    assert len({a.ledger_manager.last_closed_hash() for a in live}) == 1


def test_restart_node_keeps_the_device(tmp_path):
    sim = core(4, persist_dir=str(tmp_path), device="cpu", **HOST)
    sim.start_all_nodes()
    settle(sim)
    assert sim.close_ledger()
    victim = list(sim.nodes)[3]
    sim.crash_node(victim)
    assert sim.close_ledger()
    app = sim.restart_node(victim)
    assert app is sim.nodes[victim]
    assert app.device == torch.device("cpu")
    assert app.herder.scp.tally_device == torch.device("cpu")
    settle(sim)
    assert sim.close_ledger(timeout=200)
    sim.assert_in_sync()
    assert sim.assert_no_forks() > 0
    assert tally_stats(sim)[0] > 0


@pytest.mark.parametrize("build", [
    lambda: core(4), lambda: pair(), lambda: cycle(3),
    lambda: hierarchical_quorum(2, 2),
    lambda: Simulation().add_node(_seeds(1)[0], {
        "threshold": 1, "validators": _ids(_seeds(1))}),
], ids=["core4", "pair", "cycle3", "hierarchical2x2", "add_node"])
def test_no_gpu_and_no_device_raises(build):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_network_phase_at_small_size():
    lines = []
    a = run_network("cpu", "both", device="cpu", n_orgs=3, per_org=3,
                    emit_line=lines.append)
    b = run_network("cpu", "host", n_orgs=3, per_org=3)
    assert a["hashes"] == b["hashes"] and len(set(a["hashes"])) == 3
    assert [line["txs"] for line in lines] == [1, 100, 100]
    assert all(line["nodes_equal"] == 9 and line["tally_calls"] > 0 and
               line["overlay_launches"] == line["close_launches"] == 0
               for line in lines)
    assert a["forged"] == b["forged"] == {"seq": 3, "primed": False,
                                          "state": "INVALID"}
    assert a["counters"]["overlay.sigbatch.batches"] == len(a["batches"]) \
        == len(b["batches"]) > 0
    # the host verified every batch
    assert a["kept_batch"] is None and a["launched_triples"] == []
