"""Simulated networks and the golden scenarios with their signature batches
on the card.

1. core-4 on ``CRYPTO_BACKEND="cuda"`` with ``both`` tallies closes 2
   ledgers: every overlay batch of 2 or more triples is one launch of the
   CUDA verify kernel, there are some, and a forged envelope drained beside
   its original is primed ``False`` and refused by SCP.
2. ``chip_smoke.run_network`` at 3 x 3 on ``cuda`` (the card's ``network``
   phase, cut to 9 validators): every check of the phase, and the same
   header hashes as the ``cpu``-backend network.
3. ``tests/test_golden_meta.py``'s four scenarios on a ``cuda`` node (its
   close's signature batch through the kernel) give ``GOLDEN.json``'s
   digests.

It imports only torch, numpy and the port (the GPU host has no jax) and
skips with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_network.py -m cuda --noconftest -q

Tolerance: exact (verdicts, counts, hashes, digests)."""
import pytest
import torch

from chip_smoke import run_network, settle
from stellar_core_tpu_torch.main import Application
from stellar_core_tpu_torch.main.config import test_config as node_config
from stellar_core_tpu_torch.utils.device import signature_columns
from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
from stellar_core_tpu_torch.scp.slot import EnvelopeState
from stellar_core_tpu_torch.simulation import core
from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock
from stellar_core_tpu_torch.xdr import types as T
from tests.test_torch_golden import SCENARIOS, golden, golden_digest


def needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_core4_envelope_batches_on_card():
    needs_gpu()
    sim = core(4, CRYPTO_BACKEND="cuda", SCP_TALLY_BACKEND="both")
    apps = list(sim.nodes.values())
    assert all(app.device.type == "cuda" for app in apps)
    before = ed25519_cuda.launches
    sim.start_all_nodes()
    settle(sim)
    for _ in range(2):
        assert sim.close_ledger()
        sim.assert_in_sync()
    assert apps[0].ledger_manager.last_closed_seq() == 3
    batches = sum(app.metrics.counter("overlay.sigbatch.batches").count
                  for app in apps)
    overlay = ed25519_cuda.launches - before
    assert 0 < overlay <= batches
    # a peer's envelope of the last slot and its forged copy, one drain
    a, b = apps[0], apps[1]
    env = next(e for e in a.herder.scp.get_current_state_envelopes(
        max(a.herder.scp.slots))
        if e.statement.nodeID.value == b.config.node_id())
    forged = T.SCPEnvelope.make(statement=env.statement, signature=bytes(64))
    driver = a.herder.driver
    before = ed25519_cuda.launches
    a.overlay_manager._scp_inbox.extend([env, forged])
    a.overlay_manager._drain_scp_inbox()
    assert ed25519_cuda.launches - before == 1
    assert driver._sig_verdicts[driver.envelope_sig_triple(env)] is True
    assert driver._sig_verdicts[driver.envelope_sig_triple(forged)] is False
    assert a.herder.scp.receive_envelope(forged) == EnvelopeState.INVALID


@pytest.mark.cuda
def test_network_phase_at_3x3_on_card():
    needs_gpu()
    dev = torch.device("cuda")
    before = ed25519_cuda.launches
    a = run_network("cuda", "both", dev, n_orgs=3, per_org=3)
    overlay = sum(launches for _, _, launches, _ in a["batches"])
    assert overlay > 0 and sum(a["closes"]) == 3 * 9
    assert ed25519_cuda.launches - before == overlay + sum(a["closes"])
    assert a["forged"] == {"seq": 3, "primed": False, "state": "INVALID"}
    assert a["kept_batch"] is not None
    # the kernel equals its plain version on every distinct triple that
    # the launched overlay batches carried, the forged one among them
    rows = [torch.as_tensor(c, device=dev)
            for c in signature_columns(a["launched_triples"])]
    want = ed25519_kernel.verify_batch(*rows)
    assert torch.equal(ed25519_cuda.verify_batch(*rows), want)
    assert int((~want).sum()) >= 1
    b = run_network("cpu", "host", n_orgs=3, per_org=3)
    assert a["hashes"] == b["hashes"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENARIOS)
def test_golden_scenario_on_card(name):
    needs_gpu()

    def cuda_node():
        app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config(
            CRYPTO_BACKEND="cuda", SCP_TALLY_BACKEND="tensor"))
        app.start()
        assert app.device.type == "cuda"
        return app

    before = ed25519_cuda.launches
    assert golden_digest(name, cuda_node) == golden()[name]
    assert ed25519_cuda.launches > before
