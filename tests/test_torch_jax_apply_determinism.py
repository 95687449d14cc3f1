"""``tests/test_apply_determinism.py`` on the port: the apply path's
determinism guard.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's and its imports of
sibling test files rebound to their port modules
(``test_torch_golden.port_module``); its fixtures go with them.
Every case runs from its own directory.

Its hash-seed case starts ``python -c`` workers under different
``PYTHONHASHSEED``s; their script imports the port's text of this
file, written under the case's directory, and ends by asserting that
the worker imported no JAX (``PORT_REPLACE``).

Tolerance: the file's own.
"""
from .test_torch_golden import (assert_runs_on_the_port,
                                assert_worker_on_the_port, port_module,
                                port_modules_for_workers, _port_tests)
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)

_M = port_module("test_apply_determinism")
globals().update(_port_tests(_M))
port_modules_for_workers = port_modules_for_workers(_M)


def test_cases_run_on_the_port():
    assert_runs_on_the_port(_M, globals())


def test_hashseed_worker_runs_the_port():
    assert_worker_on_the_port(_M._HASHSEED_WORKER)
