"""``tests/test_scp_order_invariance.py`` on the port: SCP's invariance
under envelope order and hash seed.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's and its imports of sibling test
files rebound to their port modules (``test_torch_golden.port_module``).
Every case runs from its own directory.

The tally case calls ``TallyEngine(slot, "tensor")`` as the reference's
signature has it (ROADMAP C5), and that call is not rewritten: the device
it resolves through ``utils.device.default_device`` is pinned to the CPU
here, for each case, by a fixture.

Its hash-seed case starts ``python -c`` workers under four
``PYTHONHASHSEED``s; their script imports the port's text of this file
and of ``tests/test_scp.py``, written under the case's directory, and
ends by asserting that the worker imported no JAX (``PORT_REPLACE``).

Tolerance: the file's own.
"""
import pytest
import torch

from stellar_core_tpu_torch.scp import tally

from .test_torch_golden import (_PORT_TEXTS, assert_runs_on_the_port,
                                assert_worker_on_the_port, port_module,
                                port_modules_for_workers, _port_tests)
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)

_M = port_module("test_scp_order_invariance")
globals().update(_port_tests(_M))
port_modules_for_workers = port_modules_for_workers(_M)


@pytest.fixture(autouse=True)
def tally_device_is_the_cpu(monkeypatch):
    monkeypatch.setattr(tally, "default_device",
                        lambda device=None: torch.device(device or "cpu"))


def test_cases_run_on_the_port():
    assert_runs_on_the_port(_M, globals())
    assert 'slot.tally = TallyEngine(slot, "tensor")\n' in \
        _PORT_TEXTS[_M.__name__][0]
    scp, _, _ = _M.mk_scp()
    engine = tally.TallyEngine(scp.get_slot(1), "tensor")
    assert engine.device == torch.device("cpu")


def test_hashseed_worker_runs_the_port():
    assert_worker_on_the_port(_M._NOMINATION_WORKER)
