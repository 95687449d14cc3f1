"""The JAX test files of the device seam, run on the port on the card
with nothing pinned: ``tests/test_sigbatch.py``,
``tests/test_scp_tensor_tally.py`` and ``tests/test_consensus_recovery.py``
case by case, and ``tests/test_scp_order_invariance.py``'s tally case.

Each case runs as the very code of its file on the port
(``test_torch_golden.port_module``, as the CPU collecting files
``tests/test_torch_jax_<stem>.py`` run it), but with no ``device=`` and no
backend pinned: every node's ``auto`` backends and the tally engine's
``device=None`` resolve to ``cuda``, so the overlay's signature batches go
through the CUDA verify kernel and the tensor tallies run on the card.
Every tally engine a case builds is checked to be on ``cuda``, and each
case must reach the card (kernel launches or tensor tallies there).

It imports only torch, numpy and the port (the GPU host has no jax) and
skips with a reason where there is no GPU.  On a GPU host, without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda_jax_files.py -m cuda --noconftest -q

Tolerance: the files' own (exact verdicts, hashes and counts)."""
import pytest
import torch

from stellar_core_tpu_torch.ops import ed25519_cuda
from stellar_core_tpu_torch.scp import tally
from tests.test_torch_golden import TESTS, port_module, text_cases

FILES = ("test_sigbatch", "test_scp_tensor_tally", "test_consensus_recovery")
CASES = [(stem, name) for stem in FILES
         for name in sorted(text_cases(TESTS / f"{stem}.py"))] + [
    ("test_scp_order_invariance",
     "test_tensor_tally_build_invariant_under_envelope_order")]


@pytest.fixture
def tally_devices(monkeypatch):
    """The device of every tally engine built during the case."""
    devices, init = [], tally.TallyEngine.__init__

    def recording_init(self, *args, **kw):
        init(self, *args, **kw)
        devices.append(self.device)

    monkeypatch.setattr(tally.TallyEngine, "__init__", recording_init)
    return devices


@pytest.mark.cuda
@pytest.mark.parametrize("stem,name", CASES)
def test_jax_case_on_the_card(stem, name, tmp_path, monkeypatch,
                              tally_devices):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    monkeypatch.chdir(tmp_path)   # the nodes' slow-close traces
    case = getattr(port_module(stem), name)
    before = ed25519_cuda.launches
    if "tmp_path" in case.__code__.co_varnames[:case.__code__.co_argcount]:
        case(tmp_path)
    else:
        case()
    launches = ed25519_cuda.launches - before
    assert all(d is not None and d.type == "cuda" for d in tally_devices)
    assert launches > 0 or tally_devices, (stem, name)


def test_cases_are_the_files_cases():
    assert len(CASES) == 11
    assert {n for s, n in CASES if s == "test_sigbatch"} == \
        text_cases(TESTS / "test_sigbatch.py")
