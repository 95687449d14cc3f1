"""The live tally kernel on the card (``csrc/quorum_tally.cu`` through
``ops/quorum_cuda.py``).

1. On every case of ``tests/test_torch_tally_host.py``: the kernel's
   verdict = the plain version's (the engine's torch ops on the CPU) = the
   host oracle's (sane cases), accept and ratify, through a CUDA engine's
   ``device_accept``/``device_ratify``, one launch a call and no torch
   contraction.  Then launches back to back over cases whose qsets
   differ, in turns, each held to the plain version.
2. ``hierarchical_quorum(7, 3)`` with ``both`` tallies and ``cuda`` verify
   closes 2 ledgers: no TallyMismatch, the header hashes of the ``cpu``
   network with host tallies, and the kernel's launches = the engines'
   ``tensor_tallies``: every tensor tally on the card was one launch.
3. A wrong device, dtype, shape or layout raises.

It imports only torch, numpy and the port (the GPU host has no jax) and
skips with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_tally.py -m cuda --noconftest -q

Tolerance: exact (verdicts, counts, hashes)."""
import numpy as np
import pytest
import torch

from chip_smoke import settle
from stellar_core_tpu_torch.ops import quorum as Q
from stellar_core_tpu_torch.ops import quorum_cuda
from stellar_core_tpu_torch.scp.tally import TallyEngine
from stellar_core_tpu_torch.simulation import hierarchical_quorum
from tests.test_torch_tally_host import (CASE_NAMES, KINDS, case, kind_rows,
                                         oracle_tally, plain_tally)


def needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASE_NAMES)
def test_kernel_equals_plain_and_oracle(name, monkeypatch):
    needs_gpu()
    c = case(name)
    local_qs, qsets = c.tensors(device="cuda")
    cpu_local, cpu_qsets = c.tensors()
    engine = TallyEngine(None, "tensor", device="cuda")
    calls = [(kind, rows) for rows in c.draws(seed=len(name))
             for kind in KINDS]
    want = [plain_tally(kind, cpu_local, cpu_qsets, rows)[0]
            for kind, rows in calls]

    def no_torch_trip(*args):
        raise AssertionError("a CUDA tally ran a torch contraction")

    monkeypatch.setattr(Q, "_contract_trip", no_torch_trip)
    before = quorum_cuda.launches
    got = [(engine.device_accept if kind == "accept" else
            engine.device_ratify)(local_qs, qsets, kind_rows(kind, rows))
           for kind, rows in calls]
    assert quorum_cuda.launches - before == len(calls)
    assert all(type(v) is bool for v in got)
    assert got == want
    assert set(got) == {False, True}
    if c.sane:
        assert got == [oracle_tally(c, kind, rows) for kind, rows in calls]


@pytest.mark.cuda
def test_back_to_back_launches_over_different_qsets():
    """Launches one after another over cases whose qsets differ, in turns
    (the hierarchical, sane and wild random cases and tier 1), each
    verdict held to the plain version: a launch decides on its own qsets
    and rows, whatever the launch before it left in shared memory, and no
    warp reads shared memory before the barrier that covers its writes.
    The host check runs the block as one lane and cannot see a missing
    barrier; this can."""
    needs_gpu()
    setups = []
    for name in CASE_NAMES:
        if name.startswith(("hierarchical", "random_sane", "random_wild",
                            "tier1")):
            c = case(name)
            setups.append((c.tensors(device="cuda"), c.tensors(),
                           c.draws(seed=7 + len(name))))
    calls = [(kind, card, cpu, draws[i % len(draws)])
             for i in range(max(len(s[2]) for s in setups))
             for card, cpu, draws in setups for kind in KINDS]
    want = [plain_tally(kind, *cpu, rows)[0] for kind, _, cpu, rows in calls]
    for _ in range(3):
        got = [(quorum_cuda.tally_accept if kind == "accept" else
                quorum_cuda.tally_ratify)(*card, kind_rows(kind, rows))
               for kind, card, _, rows in calls]
        assert got == want


@pytest.mark.cuda
def test_network_7x3_both_on_card(monkeypatch):
    needs_gpu()
    engines = []
    real_init = TallyEngine.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        engines.append(self)

    monkeypatch.setattr(TallyEngine, "__init__", init)

    def close_two(device, crypto, tally):
        sim = hierarchical_quorum(7, 3, device=device,
                                  CRYPTO_BACKEND=crypto,
                                  SCP_TALLY_BACKEND=tally)
        sim.start_all_nodes()
        settle(sim)
        for _ in range(2):
            assert sim.close_ledger()
            sim.assert_in_sync()
        return [[sim.header_chain(nid)[seq] for seq in (2, 3)]
                for nid in sim.nodes]

    before = quorum_cuda.launches
    card = close_two(torch.device("cuda"), "cuda", "both")
    launches = quorum_cuda.launches - before
    card_engines = list(engines)
    assert card_engines and all(e.device.type == "cuda"
                                for e in card_engines)
    assert sum(e.host_fallbacks for e in card_engines) == 0
    tallies = sum(e.tensor_tallies for e in card_engines)
    assert tallies > 0 and launches == tallies
    host = close_two("cpu", "cpu", "host")
    assert len({tuple(chain) for chain in card}) == 1
    assert card == host


@pytest.mark.cuda
def test_wrong_inputs_raise():
    needs_gpu()
    c = case("tier1_7x3")
    local_qs, qsets = c.tensors(device="cuda")
    rows = c.draws(seed=1)[5]
    assert isinstance(quorum_cuda.tally_accept(local_qs, qsets, rows), bool)
    bad = [
        (local_qs, qsets, rows.astype(np.uint8)),                # dtype
        (local_qs, qsets, rows[:, :20]),                         # width
        (local_qs, qsets, np.vstack([rows, rows])),              # rows
        (local_qs, qsets, torch.from_numpy(rows)),               # not numpy
        (local_qs, qsets._replace(top_thr=qsets.top_thr.long()), rows),
        (local_qs, qsets._replace(
            top_mem=qsets.top_mem.t().contiguous().t()), rows),  # layout
        (local_qs._replace(inner_mem=local_qs.inner_mem[:, :20]), qsets,
         rows),                                                  # shape
        (local_qs._replace(top_mem=local_qs.top_mem.cpu()), qsets, rows),
        c.tensors() + (rows,),                                   # CPU
    ]
    before = quorum_cuda.launches
    for args in bad:
        with pytest.raises(ValueError):
            quorum_cuda.tally_accept(*args)
    with pytest.raises(ValueError):
        quorum_cuda.tally_ratify(local_qs, qsets, rows)          # 2 rows
    assert quorum_cuda.launches == before
