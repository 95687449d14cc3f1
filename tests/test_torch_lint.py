"""The port's detlint (``stellar_core_tpu_torch/tools/lint``: copies of
``tools/lint`` pointed at the port's package) held to the repository's
``tests/test_detlint.py``: every case of that file runs against the port's
linter, as the very code of the file with the package's dotted name and
its paths written the port's, ``tools.lint`` the port's linter and the
``verify_green --lint-only`` gate the port's (with ``--device cpu``).  So
the port's tree is clean with an empty baseline, and each injection
(pointed at the port's modules) goes red.  The cases are split over this
file and ``tests/test_torch_lint_conc.py`` (``SECOND``), so that neither
sets the suite's tail.

Beside them: the two linters give the same findings, path for path, on
the same injected source texts.

Tolerance: exact (findings, exit codes).
"""
import pytest

from .test_torch_golden import TESTS, _as_port_module, _port_tests

PKG = "stellar_core_tpu_torch"
_DL = _as_port_module(
    "torch_detlint", TESTS / "test_detlint.py",
    **{"from tools.lint": f"from {PKG}.tools.lint",
       '"-m", "tools.lint"': f'"-m", "{PKG}.tools.lint"',
       '"stellar_core_tpu/': f'"{PKG}/',
       '/ "stellar_core_tpu"': f'/ "{PKG}"',
       '[sys.executable, "tools/verify_green.py", "--lint-only"]':
       f'[sys.executable, "-m", "{PKG}.tools.verify_green", "--lint-only", '
       '"--device", "cpu"]'})

#: the cases of tests/test_detlint.py that tests/test_torch_lint_conc.py
#: runs: the srchash, safety, --changed, gate and concurrency cases
#: (from ``test_srchash_sidecar_audit`` on, but the ``--threads`` dump)
_NAMES = list(_port_tests(_DL))
SECOND = set(_NAMES[_NAMES.index("test_srchash_sidecar_audit"):]) - {
    "test_conc_threads_dump_cli"}
globals().update({n: t for n, t in _port_tests(_DL).items()
                  if n not in SECOND})


def test_detlint_cases_run_on_the_port_linter():
    from stellar_core_tpu_torch.tools.lint import engine

    text = (TESTS / "test_detlint.py").read_text()
    assert len(_NAMES) == text.count("\ndef test_")
    assert _DL.lint_repo is engine.lint_repo and engine.PACKAGE == PKG
    assert _DL.REPO == str(TESTS.parent) and _DL.TALLY.startswith(f"{PKG}/")
    assert set(_NAMES) - SECOND <= set(globals()) and len(SECOND) > 20


# the same source texts, linted by both linters at the same package path
INJECTED = {
    "scp/tally.py": _DL._tally_source().replace(f"{PKG}.",
                                                "stellar_core_tpu.") + '''

def _fingerprint(envelopes):
    import hashlib
    h = hashlib.sha256()
    for n, env in envelopes.items():
        h.update(n)
    return h.digest()


def _stamp(slot):
    import time
    return time.time()


def tally(votes, seen=set()):
    try:
        return votes
    except Exception:
        pass
''',
    "bucket/injected.py": '''
import os


def bad(path):
    f = open(path, "rb")
    data = f.read()
    f.close()
    return data
''',
    "ops/injected_kernel.py": '''
import os
from functools import partial

import jax


@partial(jax.jit, static_argnums=0)
def kernel(n, x):
    print("tracing", os.environ.get("X"))
    return x
''',
    "ledger/injected_a.py": _DL._ENGINE_SRC,
    "bucket/locked.py": _DL._LOCKED_MODULE,
    "native/injected.cpp": '''#include <Python.h>
static PyObject *f(PyObject *s) {
    Py_BEGIN_ALLOW_THREADS;
    PyErr_Clear();
    Py_END_ALLOW_THREADS;
    PyObject *o = PyList_New(3);
    return o;
}
''',
}


@pytest.mark.parametrize("rel", sorted(INJECTED))
def test_both_linters_give_the_same_findings(rel):
    from tools.lint import lint_sources as jax_lint

    from stellar_core_tpu_torch.tools.lint import lint_sources

    src = INJECTED[rel]
    want = jax_lint({f"stellar_core_tpu/{rel}": src})
    got = lint_sources({f"{PKG}/{rel}": src.replace(
        "stellar_core_tpu.", f"{PKG}.")})
    assert want, rel

    def norm(findings, pkg):
        return [f.render().replace(f"{pkg}/", "PKG/").replace(
            f"{pkg}.", "PKG.") for f in findings]

    assert norm(got, PKG) == norm(want, "stellar_core_tpu")


def test_native_handles_are_lock_annotated():
    """tests/test_native_apply.py::test_detlint_covers_native_apply_and_
    kernel_handle on the port: ``apply`` rides detlint's consensus scope,
    and the native loader's library handles stay lock-annotated, so the
    guarded-by audit bites on them.  The port has no ``_applykernel_tried``
    flag: its getters raise on a failed build instead of remembering it
    (a kept divergence)."""
    import os

    from stellar_core_tpu_torch.tools.lint.engine import (CONSENSUS_DIRS,
                                                          REPO, _parse_file)

    assert "apply" in CONSENSUS_DIRS
    rel = f"{PKG}/native/__init__.py"
    with open(os.path.join(REPO, rel)) as f:
        info = _parse_file(rel, f.read())
    guarded = {info.line_text(line).split("=")[0].strip().split(":")[0]
               .strip() for line in info.guards}
    assert {"_lib", "_xdrpack_mod", "_applykernel_mod"} <= guarded
    assert not any(name.endswith("_tried") for name in guarded)
