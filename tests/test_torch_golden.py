"""The port's node held to the repo's golden corpus,
``tests/golden/GOLDEN.json``: ``tests/test_golden_meta.py``'s four
scenarios (payments; trust lines and a crossed offer; a sponsored account,
a claimable balance, a pool deposit and a fee bump; auth revocation with
pulled offers and pool shares redeemed into claimable balances) close on a
port node on the ``cpu`` backend, and every scenario's digest (the sha256
of its results, of its metas, the final header hash and the tx count)
equals the committed one; two runs give equal digests.

The scenarios run as the very code of ``tests/test_golden_meta.py`` and
its account helper ``tests/txtest.py``: each module's text with the
package's dotted name ``stellar_core_tpu.`` written
``stellar_core_tpu_torch.`` (the rule of the port's copies), executed as a
module of its own.  So the port runs the same scenarios, and this file
imports nothing of the JAX package.

Tolerance: exact (digests).
"""
import json
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent


def _as_port_module(name: str, path: Path, **replace) -> types.ModuleType:
    """The test module at ``path`` with the port's imports, as module
    ``name`` (``replace``: further text substitutions)."""
    if name in sys.modules:
        return sys.modules[name]
    text = path.read_text().replace("stellar_core_tpu.",
                                    "stellar_core_tpu_torch.")
    for old, new in replace.items():
        assert old in text, old
        text = text.replace(old, new)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def _port_tests(mod: types.ModuleType) -> dict:
    """The test functions and classes that ``mod``'s own text defines (a
    test file run on the port by ``_as_port_module``), to collect in the
    file that runs it; their marks go with them."""
    return {name: obj for name, obj in vars(mod).items()
            if name.startswith(("test_", "Test"))
            and getattr(obj, "__module__", None) == mod.__name__}


def golden_module() -> types.ModuleType:
    """``tests/test_golden_meta.py`` on the port: its ``SCENARIOS``,
    ``_app``, ``_digest`` and ``GOLDEN_PATH``."""
    _as_port_module("torch_golden_txtest", TESTS / "txtest.py")
    return _as_port_module(
        "torch_golden_meta", TESTS / "test_golden_meta.py",
        **{"from .txtest import": "from torch_golden_txtest import"})


def golden_digest(name: str, app_factory=None) -> dict:
    """Scenario ``name``'s digest from a fresh port node made by
    ``app_factory`` (default: the scenarios' own, a ``test_config`` node
    on the ``cpu`` backend)."""
    g = golden_module()
    app = (app_factory or g._app)()
    g.SCENARIOS[name](app)
    return g._digest(app, from_seq=2)


def golden() -> dict:
    with open(golden_module().GOLDEN_PATH) as f:
        return json.load(f)


SCENARIOS = ("payments", "trust_and_dex", "sponsorship_cb_pool_feebump",
             "revocation")


def test_scenarios_run_on_the_port():
    g = golden_module()
    assert tuple(g.SCENARIOS) == SCENARIOS
    assert set(golden()) == set(SCENARIOS)
    names = {getattr(v, "__module__", None) or getattr(v, "__name__", "")
             for v in vars(g).values()}
    assert "stellar_core_tpu_torch.main.application" in names
    assert not any(n == "stellar_core_tpu" or n.startswith(
        "stellar_core_tpu.") for n in names)
    assert g.NodeAccount.__mro__[1].__module__ == "torch_golden_txtest"


@pytest.fixture(scope="module")
def digests():
    return {}


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_digest_equals_golden(name, digests):
    digests[name] = golden_digest(name)
    assert digests[name] == golden()[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_port_digest_is_deterministic(name, digests):
    first = digests.get(name) or golden_digest(name)
    assert golden_digest(name) == first
