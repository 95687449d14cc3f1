"""The port's runtime lockdep witness (``utils/lockdep.py``, a copy) held
to the repository's ``tests/test_lockdep.py``: its 13 cases run on the
port, as the very code of that file with the package's dotted name
written ``stellar_core_tpu_torch.`` (the disabled witness returns the raw
lock, order inversions and guard violations fail fast with their chains,
a pipelined-close port node on the host tiers runs clean under the
witness, and the witness's cost stays under its budget).  The port's
``verify_green --lockdep-smoke`` re-runs this file under ``LOCKDEP=1``.

Tolerance: exact (verdicts, counts); the overhead case keeps its bound.
"""
from .test_torch_golden import TESTS, _as_port_module, _port_tests

_LD = _as_port_module("torch_lockdep", TESTS / "test_lockdep.py")
globals().update(_port_tests(_LD))   # its fixture ``witness`` too


def test_lockdep_cases_run_on_the_port():
    text = (TESTS / "test_lockdep.py").read_text()
    names = {n for n in _port_tests(_LD) if n.startswith("test_")}
    assert len(names) == text.count("\ndef test_") == 13
    assert names <= set(globals()) and "witness" in globals()
    assert _LD.lockdep.__name__ == "stellar_core_tpu_torch.utils.lockdep"
    assert _LD.WitnessLock.__module__ == "stellar_core_tpu_torch.utils.lockdep"
