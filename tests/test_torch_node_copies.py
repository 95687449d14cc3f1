"""The port's host modules that are copies of the JAX package's stay
copies, its seams differ (the command line's only in its names), and
every relative import in the port resolves to a port module (and name):
no module awaits a later slice.

A copy is the JAX file's text with the package's dotted name
``stellar_core_tpu.`` written ``stellar_core_tpu_torch.`` (only docstrings
name it); every other byte is equal, but for a repaired fault of the JAX
text (``FAULT_FIXES``, each change spelled out).  So a silent drift of either side, or
a lazy import of a JAX-only module (``..ops.ed25519_pallas``,
``..utils.device.device_available``) that would fail only when a node
reaches it, fails here.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "stellar_core_tpu"
PORT = REPO / "stellar_core_tpu_torch"

COPIES = """
crypto/sha.py crypto/strkey.py crypto/shorthash.py
native/xdr_pack.c native/bucket_merge.cpp native/apply_kernel.cpp
native/quorum_enum.cpp
xdr/__init__.py xdr/runtime.py xdr/types.py
utils/__init__.py utils/clock.py utils/scheduler.py utils/metrics.py
utils/txtrace.py utils/floodtrace.py utils/vitals.py utils/minitoml.py
utils/lockdep.py
database/__init__.py
ledger/__init__.py ledger/packed.py
bucket/__init__.py bucket/index.py bucket/disk_bucket.py
transactions/__init__.py transactions/utils.py
transactions/signature_checker.py transactions/frame.py
transactions/fee_bump.py transactions/sponsorship.py
transactions/liquidity_pool.py transactions/offer_exchange.py
transactions/operations/__init__.py transactions/operations/account_ops.py
transactions/operations/base.py transactions/operations/claimable_balance.py
transactions/operations/liquidity_pool_ops.py
transactions/operations/offers.py transactions/operations/payments.py
transactions/operations/sponsorship_ops.py
invariant/__init__.py invariant/manager.py
apply/__init__.py apply/footprint.py apply/planner.py apply/native_apply.py
apply/executor.py
herder/upgrades.py herder/quorum_health.py
herder/quorum_tracker.py
scp/ballot.py scp/driver.py scp/qset_vector.py scp/quorum_sanity.py
scp/statement.py scp/timeline.py
work/__init__.py work/work.py process/__init__.py process/process_manager.py
history/__init__.py history/archive.py history/manager.py
catchup/__init__.py catchup/catchup_work.py catchup/manager.py
main/__init__.py
xdr/overlay_types.py crypto/curve25519.py
overlay/__init__.py overlay/peer.py overlay/peer_manager.py overlay/survey.py
overlay/tcp_peer.py
simulation/__init__.py simulation/observatory.py
simulation/load_generator.py utils/xdrquery.py main/http_server.py
simulation/chaos.py fuzzing.py simulation/fuzz/__init__.py
simulation/fuzz/minimize.py simulation/fuzz/campaign.py
""".split()

# New code where the JAX package reaches for its device: the close's
# signature batch, the overlay's per-crank envelope batch, the backend
# switches, the node's device (and the simulation's, and the fuzz
# executor's networks': tests/test_torch_fuzz.py), the native libraries'
# build directory; the command line's own name.  The node's per-ledger
# record: the queue's admission stages, the host verify's misses, the
# database's commits by thread, the flight recorder's Unix clock
# (tests/test_torch_ledger_record.py holds each); the ledger state's
# bucket-tier reads and the bucket list's background merges
# (tests/test_torch_state_reads.py).
SEAMS = """
crypto/__init__.py native/__init__.py herder/__init__.py herder/tx_set.py
herder/herder.py ledger/ledger_manager.py main/config.py main/application.py
overlay/manager.py simulation/simulation.py main/command_line.py __main__.py
simulation/fuzz/schedule.py simulation/fuzz/executor.py
herder/tx_queue.py crypto/ed25519.py database/database.py utils/tracing.py
ledger/ledger_txn.py ledger/close_pipeline.py bucket/bucket_list.py
""".split()

# The command line names its program: the JAX text with these strings
# replaced (after the package's dotted name) and no other change.
CLI_NAMES = {
    "main/command_line.py": {
        "python -m stellar_core_tpu --conf":
            "python -m stellar_core_tpu_torch --conf",
        '"stellar-core-tpu 0.3.0"': '"stellar-core-tpu-torch 0.3.0"',
        'prog="stellar-core-tpu"': 'prog="stellar-core-tpu-torch"',
    },
    "__main__.py": {
        "python -m stellar_core_tpu <subcommand>":
            "python -m stellar_core_tpu_torch <subcommand>",
    },
}

# Faults of the JAX text that a copy repairs: these strings replaced (after
# the package's dotted name) and no other change.  The metrics registry's
# lock is re-entrant, since a gc callback that registers a metric can run
# inside it (tests/test_torch_metrics.py).
FAULT_FIXES = {
    "utils/metrics.py": {
        """        # GIL-atomic.
        self._reg_lock = register_lock(threading.Lock(), "metrics.registry")""":
        """        # GIL-atomic.  Re-entrant: any allocation under the lock may
        # start a collection, whose gc callbacks (utils/vitals) register
        # metrics on the same thread; a plain Lock deadlocked there.
        self._reg_lock = register_lock(threading.RLock(), "metrics.registry")""",
        """                    m = self._metrics[name] = cls(*args)""":
        """                    # a gc callback inside cls() may register it first
                    m = self._metrics.setdefault(name, cls(*args))""",
    },
}

# The repository's tools that the port carries: ``tools/<rel>`` against
# ``stellar_core_tpu_torch/tools/<rel>``.  The copies follow the rule above.
# detlint's seams point it at the port (its package, the repository root
# one directory further up, the native sources, its own cache file and
# program name, the manifest's paths): the JAX text with these strings
# replaced and no other change.  ``fleet_scrape`` writes its JSONL to
# stdout unless ``--out`` is given (tests/test_torch_tools_trace.py).
TOOL_COPIES = """
trace_view.py lint/__init__.py lint/callgraph.py lint/concurrency.py
lint/determinism.py lint/interproc.py lint/locks.py lint/safety.py
lint/threadmodel.py lint/baseline.json
""".split()
TOOL_SEAMS = {
    "lint/engine.py": {
        "REPO = os.path.dirname(os.path.dirname(os.path.dirname(\n"
        "    os.path.abspath(__file__))))\n"
        'PACKAGE = "stellar_core_tpu"\n':
        "REPO = os.path.dirname(os.path.dirname(os.path.dirname("
        "os.path.dirname(\n"
        "    os.path.abspath(__file__)))))\n"
        'PACKAGE = "stellar_core_tpu_torch"\n',
    },
    "lint/native.py": {'NATIVE_DIR = "stellar_core_tpu/native"':
                       'NATIVE_DIR = "stellar_core_tpu_torch/native"'},
    "lint/cache.py": {'CACHE_BASENAME = ".detlint-cache.json"':
                      'CACHE_BASENAME = ".detlint-torch-cache.json"'},
    "lint/__main__.py": {
        '"""CLI: ``python -m tools.lint':
            '"""CLI: ``python -m stellar_core_tpu_torch.tools.lint',
        'prog="python -m tools.lint"':
            'prog="python -m stellar_core_tpu_torch.tools.lint"',
        '"whole stellar_core_tpu package)"':
            '"whole stellar_core_tpu_torch package)"',
    },
}
TOOL_DIFFERS = ("fleet_scrape.py",)

# Modules a later slice ports: none is left.  The node reached the last of
# them, the admin HTTP server, through ``Application.enable_tcp``.
AWAITING: set = set()


def _as_port(text: str) -> str:
    return text.replace("stellar_core_tpu.", "stellar_core_tpu_torch.")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_jax_module(rel):
    text = _as_port((JAX / rel).read_text())
    for old, new in FAULT_FIXES.get(rel, {}).items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert (PORT / rel).read_text() == text, \
        f"{rel} drifted from stellar_core_tpu/{rel}"


@pytest.mark.parametrize("rel", TOOL_COPIES)
def test_tool_copy_equals_the_repository_tool(rel):
    text = _as_port((REPO / "tools" / rel).read_text())
    assert (PORT / "tools" / rel).read_text() == text, \
        f"tools/{rel} of the port drifted from tools/{rel}"


@pytest.mark.parametrize("rel", sorted(TOOL_SEAMS))
def test_tool_seam_differs_only_in_its_names(rel):
    text = _as_port((REPO / "tools" / rel).read_text())
    for old, new in TOOL_SEAMS[rel].items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert (PORT / "tools" / rel).read_text() == text


@pytest.mark.parametrize("rel", TOOL_DIFFERS)
def test_tool_seam_differs_from_the_repository_tool(rel):
    assert (PORT / "tools" / rel).read_text() != \
        _as_port((REPO / "tools" / rel).read_text())


def test_lockstep_manifest_pins_the_port_sources():
    """The port's lockstep manifest is the repository's with every pinned
    file in the port's package, and each of them exists."""
    import json

    jax_text = (REPO / "tools" / "lint" / "lockstep.json").read_text()
    port_text = (PORT / "tools" / "lint" / "lockstep.json").read_text()
    assert port_text == jax_text.replace('"stellar_core_tpu/',
                                         '"stellar_core_tpu_torch/')
    files = {side["file"] for entry in json.loads(port_text)["constants"]
             for side in (entry["cpp"], entry.get("py")) if side}
    assert len(json.loads(port_text)["constants"]) == \
        len(json.loads(jax_text)["constants"])
    assert files and all(f.startswith("stellar_core_tpu_torch/") and
                         (REPO / f).is_file() for f in files), files


@pytest.mark.parametrize("rel", SEAMS)
def test_seam_differs_from_the_jax_module(rel):
    assert (PORT / rel).read_text() != _as_port((JAX / rel).read_text())


@pytest.mark.parametrize("rel", sorted(CLI_NAMES))
def test_cli_seam_differs_only_in_its_names(rel):
    text = _as_port((JAX / rel).read_text())
    for old, new in CLI_NAMES[rel].items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert (PORT / rel).read_text() == text


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(REPO).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _relative_imports():
    """(importing module, target module, names) of every relative import
    in the port, at any depth of the code."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        mod = _module_name(path)
        package = mod if path.name == "__init__.py" else \
            mod.rpartition(".")[0]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = package.split(".")
                base = base[:len(base) - (node.level - 1)]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
                out.append((mod, target, [a.name for a in node.names]))
    return out


def _resolves(target: str, name: str) -> bool:
    mod = importlib.import_module(target)
    if hasattr(mod, name):
        return True
    return hasattr(mod, "__path__") and \
        importlib.util.find_spec(f"{target}.{name}") is not None


def test_every_relative_import_resolves_in_the_port():
    imports = _relative_imports()
    assert len(imports) > 300
    bad = []
    for mod, target, names in imports:
        if importlib.util.find_spec(target) is None:
            bad.append((mod, target))
            continue
        bad += [(mod, f"{target}.{n}") for n in names
                if not _resolves(target, n)]
    assert not bad, bad


def test_awaiting_modules_are_absent_and_imported():
    """No module awaits a later slice: the list is empty, and the modules
    that were on it last are in the port and imported by it."""
    assert AWAITING == set()
    targets = {t for _, t, _ in _relative_imports()}
    targets |= {f"{t}.{n}" for _, t, names in _relative_imports()
                for n in names}
    for name in ("stellar_core_tpu_torch.main.http_server",
                 "stellar_core_tpu_torch.simulation.load_generator"):
        assert importlib.util.find_spec(name) is not None, name
        assert name in targets, f"{name} is imported nowhere"
