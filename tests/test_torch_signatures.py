"""Public signatures of the port equal the JAX package's, module by
module, but for the divergences named here.

Both packages are read with ``ast``; neither is imported.  For every
module of ``stellar_core_tpu/`` and its counterpart in
``stellar_core_tpu_torch/``, every public top-level function and every
public method (``__init__`` included) of a public class is compared by its
parameters: their names, their order, their defaults (as source text), and
``*args``/``**kwargs``.  A name on one side only is a difference too.

A difference is kept only where it is named:

- ``DEVICE_KEYWORDS``: the port takes the device its tensors live on as a
  further keyword (``device=None``, or ``devices=None`` for the data-
  parallel helpers) and, for a node's builders, the node settings
  (``**config_kw``), where the JAX package's device is the process's
  default.  Each must differ from the JAX signature by those added
  parameters alone, each added ``device``/``devices`` defaulting to None,
  so a call written against the reference still works.
- ``KEPT``: a module that is a rewrite (``module``), or one name of a
  seam (``module::name``), each with its reason.

An entry that no longer differs fails, so the lists shrink with the
differences.  ``ops/ed25519_pallas.py`` has no module counterpart: its
kernel is ``csrc/ed25519_verify.cu``.

A module of the port with no counterpart has its public signatures
pinned in ``PORT_ONLY``: every public name, with its parameters as
written.

Tolerance: exact (parameter lists).
"""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "stellar_core_tpu", REPO / "stellar_core_tpu_torch"

#: signatures that add the device keyword (and a node's settings) to the
#: reference's
DEVICE_KEYWORDS = (
    "herder/quorum_intersection.py::check_quorum_intersection",
    "herder/tx_set.py::TxSetFrame.prevalidate_signatures",
    "main/application.py::Application.__init__",
    "main/application.py::Application.create",
    "models/admission.py::dryrun_sharded",
    "models/admission.py::example_batch",
    "ops/quorum.py::build_qset_tensor",
    "scp/scp.py::SCP.__init__",
    "scp/tally.py::TallyEngine.__init__",
    "simulation/fuzz/executor.py::run_schedule",
    "simulation/fuzz/schedule.py::topology_factory",
    "simulation/simulation.py::Simulation.__init__",
    "simulation/simulation.py::core",
    "simulation/simulation.py::cycle",
    "simulation/simulation.py::hierarchical_quorum",
    "simulation/simulation.py::pair",
)

_REWRITE = "a rewrite in torch, held by its own port tests"
_RECORD = ("the node's per-ledger record and its Unix clock "
           "(tests/test_torch_ledger_record.py)")
_STATE = ("the per-ledger record's bucket-tier reads and background "
          "merges (tests/test_torch_state_reads.py)")

#: other kept differences: ``module`` (all of a rewritten module's) or
#: ``module::name`` -> the reason
KEPT = {
    "ops/field25519.py": _REWRITE + " (no carry switches; the kernel's "
                         "field is in csrc/)",
    "ops/scalar25519.py": _REWRITE,
    "ops/ed25519_kernel.py": _REWRITE + " (the kernel's plain version)",
    "parallel/__init__.py": _REWRITE + ": torch devices in place of a jax "
                            "Mesh and shardings",
    "utils/device.py": "the port's device policy: ``default_device`` raises "
                       "without a GPU, where the JAX package probes for a "
                       "TPU and falls back (``device_available``)",
    "models/admission.py::batch_from_numpy": "the port's batch builder",
    "models/admission.py::bench_sharded": "``devices=None`` added, and "
                                          "``n_devices`` defaults to every "
                                          "GPU",
    "models/admission.py::sharded_admission_step": "the data-parallel step "
                                                   "over torch devices",
    "models/admission.py::sharded_multi_validator_tally": "the same",
    "ops/quorum.py::contract_fixpoint": "the port's contraction helpers",
    "ops/quorum.py::contract_shared": "the same",
    "ops/quorum.py::local_qset": "the same",
    "ops/quorum.py::qset_from_numpy": "the same",
    "ops/quorum.py::shared_sets": "the same",
    "scp/tally.py::TallyEngine.device_accept": "the tensor tally's device "
                                               "step, one copy and one read",
    "scp/tally.py::TallyEngine.device_ratify": "the same",
    "main/application.py::KernelLaunches.value": "the launch counter's "
                                                 "setter",
    "native/__init__.py::get_apply_kernel": "builds or raises: the port's "
                                            "native getters never fall back "
                                            "(no ``build`` switch)",
    "native/__init__.py::extension_path": "the built library's place under "
                                          "build/torch_native/",
    "native/__init__.py::library_path": "the same",
    "simulation/simulation.py::app_header_chain": "a node's stored headers, "
                                                  "for the chip run's checks",
    "crypto/ed25519.py::verify_miss_stats": _RECORD,
    "database/database.py::Database.take_commit_stats": _RECORD,
    "herder/tx_queue.py::TransactionQueue.take_admit_stages": _RECORD,
    "ledger/ledger_manager.py::LedgerManager.seed_close_record": _RECORD,
    "ledger/ledger_manager.py::LedgerManager.add_close_phases": _RECORD,
    "utils/tracing.py::CloseRecord.__init__": _RECORD + ": "
                                              "``unix_offset_ns=None`` added",
    "utils/tracing.py::Tracer.unix_ns": _RECORD,
    "ledger/ledger_txn.py::LedgerTxnRoot.state_read_stats": _STATE,
    "ledger/ledger_txn.py::LedgerTxnRoot.note_bucket_walk": _STATE,
    "bucket/bucket_list.py::BucketList.take_merge_stats": _STATE,
}


#: port modules with no counterpart: public name -> its parameters
PORT_ONLY = {
    "ops/quorum_cuda.py": {
        "build": "",
        "tally_accept": "local_qs, qsets, rows",
        "tally_ratify": "local_qs, qsets, rows",
    },
}


def _params(fn: ast.FunctionDef) -> tuple:
    """(name, default source or None) of every parameter, in order;
    ``*name``, ``*`` and ``**name`` for the starred ones."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, None))
    elif a.kwonlyargs:
        out.append(("*", None))
    out += list(zip((p.arg for p in a.kwonlyargs), a.kw_defaults))
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, None))
    return tuple((n, None if d is None else ast.unparse(d)) for n, d in out)


def public_signatures(path: Path) -> dict:
    """name or ``Class.method`` -> parameters, for ``path``'s public
    top-level functions and its public classes' public methods."""
    out = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, funcs) and (not m.name.startswith("_") or
                                             m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = _params(m)
    return out


def differences(rel: str, jax_root: Path = JAX,
                port_root: Path = PORT) -> dict:
    """``rel::name`` -> (JAX parameters, port parameters) where they
    differ (None on the side that lacks the name)."""
    a = public_signatures(jax_root / rel)
    b = public_signatures(port_root / rel)
    return {f"{rel}::{n}": (a.get(n), b.get(n))
            for n in sorted(set(a) | set(b)) if a.get(n) != b.get(n)}


_ADDED = (("device", "None"), ("devices", "None"), ("**config_kw", None))


def only_adds_device_keywords(jax: tuple, port: tuple) -> bool:
    """``port`` is ``jax`` with ``device``/``devices`` (default None) and
    ``**config_kw`` added, the rest in order and unchanged."""
    if jax is None or port is None:
        return False
    added = [q for q in port if q in _ADDED and q not in jax]
    return len(added) == len(set(added)) and \
        [q for q in port if q not in added] == list(jax)


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                 if p.name != "ed25519_pallas.py")


def _kept(key: str) -> bool:
    return key in KEPT or key.partition("::")[0] in KEPT


@pytest.mark.parametrize("rel", MODULES)
def test_public_signatures_match_the_reference(rel):
    assert (PORT / rel).is_file(), rel
    for key, (jax, port) in differences(rel).items():
        if key in DEVICE_KEYWORDS:
            assert only_adds_device_keywords(jax, port), (key, jax, port)
        else:
            assert _kept(key), (key, jax, port)


def test_every_kept_difference_still_differs():
    found = {}
    for rel in MODULES:
        found.update(differences(rel))
    stale = [k for k in DEVICE_KEYWORDS if k not in found]
    stale += [k for k in KEPT if k not in found and not any(
        f.startswith(k + "::") for f in found)]
    assert stale == []
    assert not set(DEVICE_KEYWORDS) & set(KEPT)
    assert sorted(set(DEVICE_KEYWORDS)) == list(DEVICE_KEYWORDS)


def test_required_device_argument_is_a_difference(tmp_path):
    """The check catches a port engine that requires its device (as the
    port's ``TallyEngine.__init__(self, slot, backend, device)`` once did,
    ROADMAP C5): a reference call ``TallyEngine(slot, "tensor")`` would
    raise TypeError there."""
    rel = "scp/tally.py"
    text = (PORT / rel).read_text()
    old = "def __init__(self, slot, backend: str, device=None):"
    assert old in text
    (tmp_path / "scp").mkdir()
    (tmp_path / rel).write_text(text.replace(
        old, "def __init__(self, slot, backend: str, device):"))
    (jax, port), = [v for k, v in differences(
        rel, port_root=tmp_path).items() if k.endswith("TallyEngine.__init__")]
    assert port[-1] == ("device", None)
    assert not only_adds_device_keywords(jax, port)
    assert only_adds_device_keywords(jax, jax + (("device", "None"),))


@pytest.mark.parametrize("rel", sorted(PORT_ONLY))
def test_port_only_signatures_are_pinned(rel):
    assert not (JAX / rel).exists()
    got = {name: ", ".join(p if d is None else f"{p}={d}" for p, d in params)
           for name, params in public_signatures(PORT / rel).items()}
    assert got == PORT_ONLY[rel]
