"""The second half of ``tests/test_detlint.py``'s cases against the port's
detlint (see ``tests/test_torch_lint.py``, which loads the file and names
this half ``SECOND``): the ``.srchash`` sidecar audit (the port builds its
shared objects into ``build/torch_native/`` named by digest, so its
``native/`` holds none), the safety rules, the ``--changed`` cache against
a cold full run of the port's tree, the port's ``verify_green --lint-only``
gate, the regressions and the concurrency cases.

Tolerance: exact (findings, exit codes).
"""
from .test_torch_golden import _port_tests
from .test_torch_lint import _DL, SECOND

globals().update({n: t for n, t in _port_tests(_DL).items()
                  if n in SECOND})


def test_second_half_is_collected_here():
    assert SECOND <= set(globals())


def test_port_native_dir_holds_no_shared_object():
    from pathlib import Path

    from stellar_core_tpu_torch.tools.lint.engine import REPO
    from stellar_core_tpu_torch.tools.lint.native import NATIVE_DIR

    ndir = Path(REPO) / NATIVE_DIR
    assert ndir.is_dir() and not list(ndir.glob("*.so"))
