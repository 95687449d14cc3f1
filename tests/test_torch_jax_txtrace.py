"""``tests/test_txtrace.py`` on the port: transaction-lifecycle telemetry.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's and its imports of
sibling test files rebound to their port modules
(``test_torch_golden.port_module``); its fixtures go with them.
Every case runs from its own directory.

Every simulation a case builds is pinned here, for the case, to
``device="cpu"`` and the host tiers (a node's own ``SCP_TALLY_BACKEND``
kept): the port's builders, which put nodes on the GPU unless told
otherwise, make ``HostSimulation``s.

Its hash-seed case starts ``python -c`` workers under different
``PYTHONHASHSEED``s; their script imports the port's text of this
file, written under the case's directory, and ends by asserting that
the worker imported no JAX (``PORT_REPLACE``).

Tolerance: the file's own.
"""
import pytest

from .test_torch_golden import (assert_runs_on_the_port,
                                assert_worker_on_the_port,
                                pin_host_simulations, port_module,
                                port_modules_for_workers, _port_tests)
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)

_M = port_module("test_txtrace")
globals().update(_port_tests(_M))
port_modules_for_workers = port_modules_for_workers(_M)


@pytest.fixture(autouse=True)
def host_simulations(monkeypatch):
    pin_host_simulations(monkeypatch)


def test_cases_run_on_the_port():
    assert_runs_on_the_port(_M, globals())


def test_simulations_are_pinned_to_the_host_tiers():
    from stellar_core_tpu_torch.simulation import core

    sim = core(2)
    assert sim.device == "cpu"
    assert all((app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND) ==
               ("cpu", "host")
               for app in sim.nodes.values())


def test_hashseed_worker_runs_the_port():
    assert_worker_on_the_port(_M._HASHSEED_WORKER)
