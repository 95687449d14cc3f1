"""``tests/test_config.py`` on the port: config validation and TOML loading.

The file's own cases run as the very code of that file, with the
package's dotted name written the port's (``test_torch_golden.
port_module``); its fixtures go with them.  Every case runs from its own
directory.

One case is left out by name (``NOT_ON_PORT_CASES``):
``TestAutoBackends::test_auto_resolves_on_application_construction``
monkeypatches ``utils.device.device_available``, the JAX package's probe,
which the port does not have: on the port ``auto`` means the GPU and
raises without one, held by ``tests/test_torch_node.py::
test_device_backend_without_gpu_raises``.

Tolerance: the file's own.
"""
from .test_torch_golden import _port_tests, assert_runs_on_the_port, port_module
from .test_torch_golden import in_tmp_path  # noqa: F401 (autouse)
from .test_torch_jax_files import left_out

LEAVE_OUT = left_out("test_config")

_M = port_module("test_config")
globals().update(_port_tests(_M, LEAVE_OUT))


def test_cases_run_on_the_port():
    assert LEAVE_OUT == (
        "TestAutoBackends::test_auto_resolves_on_application_construction",)
    assert_runs_on_the_port(_M, globals(), LEAVE_OUT)
