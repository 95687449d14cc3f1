"""``tests/test_peer_manager.py`` on the port: the peer database and bans.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's and its imports of
sibling test files rebound to their port modules
(``test_torch_golden.port_module``); its fixtures go with them.
Every case runs from its own directory.

Tolerance: the file's own.
"""
from .test_torch_golden import (assert_runs_on_the_port, port_module,
                                _port_tests)
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)

_M = port_module("test_peer_manager")
globals().update(_port_tests(_M))


def test_cases_run_on_the_port():
    assert_runs_on_the_port(_M, globals())
