"""``tests/test_survey_process.py`` on the port: the survey manager and
the process manager.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's and its imports of
sibling test files rebound to their port modules
(``test_torch_golden.port_module``); its fixtures go with them.
Every case runs from its own directory.

Every simulation a case builds is pinned here, for the case, to
``device="cpu"`` and the host tiers (a node's own ``SCP_TALLY_BACKEND``
kept): the port's builders, which put nodes on the GPU unless told
otherwise, make ``HostSimulation``s.

Tolerance: the file's own.
"""
import pytest

from .test_torch_golden import (assert_runs_on_the_port, pin_host_simulations,
                                port_module, _port_tests)
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)

_M = port_module("test_survey_process")
globals().update(_port_tests(_M))


@pytest.fixture(autouse=True)
def host_simulations(monkeypatch):
    pin_host_simulations(monkeypatch, _M)


def test_cases_run_on_the_port():
    assert_runs_on_the_port(_M, globals())


def test_simulations_are_pinned_to_the_host_tiers():
    from stellar_core_tpu_torch.simulation import core

    sim = core(2)
    assert sim.device == "cpu"
    assert all((app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND) ==
               ("cpu", "host")
               for app in sim.nodes.values())
