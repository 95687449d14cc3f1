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

The harness that runs a JAX test file on the port lives here too
(``_as_port_module``, ``port_module``, ``_port_tests``,
``assert_runs_on_the_port``, ``write_port_modules``), with the pins a
collecting file uses (``HostSimulation``, ``pin_host_simulations``,
``in_tmp_path``, ``port_modules_for_workers``).

Tolerance: exact (digests).
"""
import ast
import json
import re
import sys
import types
from pathlib import Path

import pytest
from _pytest.fixtures import getfixturemarker

from stellar_core_tpu_torch.simulation import simulation as simulation_module
from stellar_core_tpu_torch.simulation.simulation import Simulation

TESTS = Path(__file__).resolve().parent

#: a test file's import of a sibling, at module level, inside a function or
#: in a worker script's text: ``from .<stem> import`` or
#: ``from tests.<stem> import``
_SIBLING = re.compile(r"^([ \t]*)from (?:\.|tests\.)(\w+) import ", re.M)

#: module name -> (the text it executed, the module names of its siblings)
_PORT_TEXTS: dict = {}


def _as_port_module(name: str, path: Path, **replace) -> types.ModuleType:
    """The test module at ``path`` with the port's imports, as module
    ``name`` (``replace``: further text substitutions, each of which must
    find its text).  Every import of a sibling file of ``tests/`` that is
    left is rebound to that file's port module (``port_module``), loaded
    first, so a sibling runs once a process whichever file reaches it."""
    if name in sys.modules:
        return sys.modules[name]
    text = path.read_text().replace("stellar_core_tpu.",
                                    "stellar_core_tpu_torch.")
    for old, new in replace.items():
        assert old in text, old
        text = text.replace(old, new)
    siblings = {}
    for stem in sorted({m.group(2) for m in _SIBLING.finditer(text)}):
        if (TESTS / f"{stem}.py").is_file():
            siblings[stem] = (name if TESTS / f"{stem}.py" == path
                              else port_module(stem).__name__)
    text = _SIBLING.sub(
        lambda m: (f"{m.group(1)}from {siblings[m.group(2)]} import "
                   if m.group(2) in siblings else m.group(0)), text)
    _PORT_TEXTS[name] = (text, sorted(set(siblings.values()) - {name}))
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


#: a hash-seed case's worker script, run with ``python -c``: it puts the
#: directory of the port modules (``write_port_modules``, named by the
#: environment's ``PORT_TEST_MODULES``) on its path, so its rebound
#: ``from port_<stem> import`` finds the port's text, and it ends by
#: asserting that it imported no JAX
_WORKER_PATH = {
    "import sys\n\nsys.path.insert(0, {repo!r})\n":
    "import os\nimport sys\n\nsys.path.insert(0, {repo!r})\n"
    "sys.path.insert(0, os.environ['PORT_TEST_MODULES'])\n"}
_NO_JAX = '\nassert "jax" not in sys.modules\n"""'
_FINGERPRINT_WORKER = {
    **_WORKER_PATH,
    '    print(lh.hex(), bh.hex(), hashlib.sha256(meta).hexdigest())\n"""':
    '    print(lh.hex(), bh.hex(), hashlib.sha256(meta).hexdigest())'
    + _NO_JAX,
    # the worker's node writes its slow-close traces into its cwd
    "cwd=repo, env=env": "cwd=os.getcwd(), env=env"}


def _tools(*names: str) -> dict:
    """``from tools.<name> import`` as the port's tool."""
    return {f"from tools.{n} import": f"from stellar_core_tpu_torch.tools.{n}"
            " import" for n in names}


#: the text changes beyond the package's name that a file of ``tests/``
#: takes on the port: one set a file, so a file whichever collecting file
#: or sibling loads it first runs the same text
PORT_REPLACE = {
    "test_apply_determinism": _FINGERPRINT_WORKER,
    "test_native_fee": _FINGERPRINT_WORKER,
    "test_pipelined_close": _FINGERPRINT_WORKER,
    "test_txtrace": _FINGERPRINT_WORKER,
    "test_parallel_apply": {**_FINGERPRINT_WORKER,
                            **_tools("lint.engine")},
    "test_native_apply": {
        **_FINGERPRINT_WORKER, **_tools("lint.engine"),
        '"stellar_core_tpu/native/__init__.py"':
        '"stellar_core_tpu_torch/native/__init__.py"'},
    "test_scp_order_invariance": {
        **_WORKER_PATH,
        '    print(v.hex())\n"""': "    print(v.hex())" + _NO_JAX,
        "cwd=REPO, env=env": "cwd=os.getcwd(), env=env"},
    "test_bucket_list": {'"-m", "stellar_core_tpu",':
                         '"-m", "stellar_core_tpu_torch",'},
    "test_tcp_node": {'"-m", "stellar_core_tpu",':
                      '"-m", "stellar_core_tpu_torch",'},
    "test_observatory": {"from tools import fleet_scrape":
                         "from stellar_core_tpu_torch.tools import "
                         "fleet_scrape"},
    "test_consensus_forensics": _tools("trace_view"),
    "test_tracing": _tools("trace_view"),
}


def port_module(stem: str) -> types.ModuleType:
    """``tests/<stem>.py`` on the port, as module ``port_<stem>`` (one a
    process), with its ``PORT_REPLACE`` changes."""
    return _as_port_module(f"port_{stem}", TESTS / f"{stem}.py",
                           **PORT_REPLACE.get(stem, {}))


def write_port_modules(mod: types.ModuleType, dest: Path) -> Path:
    """Write the text ``mod`` executed, and its siblings', as
    ``<module name>.py`` files in ``dest``, so that a child process with
    ``dest`` on its path imports the same port modules; returns ``dest``."""
    dest.mkdir(parents=True, exist_ok=True)
    todo = [mod.__name__]
    while todo:
        name = todo.pop()
        if not (dest / f"{name}.py").exists():
            text, siblings = _PORT_TEXTS[name]
            (dest / f"{name}.py").write_text(text)
            todo += siblings
    return dest


def _port_tests(mod: types.ModuleType, leave_out=()) -> dict:
    """The test functions and classes that ``mod``'s own text defines (a
    test file run on the port by ``_as_port_module``), with every pytest
    fixture in its namespace (the autouse ones too) and its
    ``pytestmark``, to collect in the file that runs it; their marks go
    with them.  ``leave_out`` names cases not to collect: ``function`` or
    ``Class::method`` (the class collected as a subclass without it)."""
    out = {name: obj for name, obj in vars(mod).items()
           if name.startswith(("test_", "Test"))
           and getattr(obj, "__module__", None) == mod.__name__}
    for case in leave_out:
        name, _, method = case.partition("::")
        if method:
            out[name] = type(name, (out[name],), {method: None,
                                                  "__module__": mod.__name__})
        else:
            del out[name]
    out.update({name: obj for name, obj in vars(mod).items()
                if getfixturemarker(obj) is not None})
    if hasattr(mod, "pytestmark"):
        out["pytestmark"] = mod.pytestmark
    return out


def text_cases(path: Path) -> set:
    """The test functions and classes defined at the top of ``path``."""
    return {node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))
            and node.name.startswith(("test_", "Test"))}


def _is_jax(name: str) -> bool:
    return name in ("jax", "stellar_core_tpu", "tools") or name.startswith(
        ("jax.", "stellar_core_tpu.", "tools."))


def assert_runs_on_the_port(mod: types.ModuleType, namespace: dict,
                            leave_out=()) -> None:
    """Every case of ``mod``'s JAX file but those of ``leave_out`` (as for
    ``_port_tests``) is collected in ``namespace`` (the collecting file's
    globals), and ``mod`` and its siblings reach only the port: every
    module object, and the module of every class and function, in their
    namespaces is none of ``jax``, the JAX package or its ``tools``, and
    the port's package is among them."""
    cases = {n for n in _port_tests(mod) if n.startswith(("test_", "Test"))}
    assert cases == text_cases(Path(mod.__file__)), mod.__file__
    held = {case.partition("::")[0]: case.partition("::")[2]
            for case in leave_out}
    for name in cases:
        got, want = namespace.get(name), getattr(mod, name)
        if held.get(name):
            assert got.__bases__ == (want,) and getattr(got, held[name]) \
                is None and callable(getattr(want, held[name]))
        else:
            assert (got is None) if name in held else (got is want), name
    seen, todo, names = set(), [mod.__name__], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo += _PORT_TEXTS[name][1]
        for obj in vars(sys.modules[name]).values():
            if isinstance(obj, types.ModuleType):
                names.add(obj.__name__)
            elif isinstance(obj, (type, types.FunctionType)):
                names.add(obj.__module__ or "")
    assert not [n for n in names if _is_jax(n)], mod.__file__
    assert any(n.startswith("stellar_core_tpu_torch.") for n in names)
    for name in seen:
        text = _PORT_TEXTS[name][0]
        assert not re.search(r"^\s*(from|import) (jax|tools|stellar_core_tpu)"
                             r"\b", text, re.M), name
        assert not re.search(r'"-m", "(tools|stellar_core_tpu)\b', text), name


HOST = {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}


class HostSimulation(Simulation):
    """The port's ``Simulation`` on ``device="cpu"`` whose nodes run the
    host tiers unless a node's own keywords name a backend."""

    def __init__(self, *args, **kw):
        kw["device"] = kw.get("device") or "cpu"
        super().__init__(*args, **kw)

    def add_node(self, seed, qset_spec, node_dir=None, **config_kw):
        return super().add_node(seed, qset_spec, node_dir=node_dir,
                                **{**HOST, **config_kw})


def pin_host_simulations(monkeypatch, *modules) -> None:
    """For one test: every ``Simulation`` that the port's builders
    (``core``, ``pair``, ``cycle``, ``hierarchical_quorum``) make, and the
    ``Simulation`` name of each of ``modules`` (executed JAX test files),
    is a ``HostSimulation``."""
    monkeypatch.setattr(simulation_module, "Simulation", HostSimulation)
    for mod in modules:
        monkeypatch.setattr(mod, "Simulation", HostSimulation)


def port_modules_for_workers(mod: types.ModuleType):
    """An autouse fixture for the file that collects ``mod``: its
    hash-seed cases start ``python -c`` workers, which import ``mod`` and
    its siblings as the port's text written under the test's own
    directory (``PORT_TEST_MODULES``) and run from there."""
    @pytest.fixture(autouse=True)
    def port_modules_for_workers(tmp_path, monkeypatch):
        dest = write_port_modules(mod, tmp_path / "port_modules")
        monkeypatch.setenv("PORT_TEST_MODULES", str(dest))
        monkeypatch.chdir(tmp_path)
    return port_modules_for_workers


def assert_worker_on_the_port(worker: str) -> None:
    """A hash-seed worker script imports the port's modules from
    ``PORT_TEST_MODULES`` and ends by asserting it imported no JAX."""
    assert "os.environ['PORT_TEST_MODULES']" in worker
    assert re.search(r"^from port_test_\w+ import ", worker, re.M)
    assert worker.rstrip().endswith('assert "jax" not in sys.modules')
    assert not re.search(r"\b(tests\.|stellar_core_tpu\.)", worker)


@pytest.fixture(autouse=True)
def in_tmp_path(tmp_path, monkeypatch):
    """Every case runs from its own directory: a node's slow-close traces go
    to its ``TRACE_DIR``, ``traces`` in the cwd by default, never the
    checkout's (ROADMAP C2).  A collecting file imports it, and it is
    autouse there."""
    monkeypatch.chdir(tmp_path)


def golden_module() -> types.ModuleType:
    """``tests/test_golden_meta.py`` on the port: its ``SCENARIOS``,
    ``_app``, ``_digest`` and ``GOLDEN_PATH``."""
    return port_module("test_golden_meta")


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
    assert g.NodeAccount.__mro__[1].__module__ == "port_txtest"


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
