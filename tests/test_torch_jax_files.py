"""Every JAX test file of ``tests/`` is held on the port, or named here.

A JAX test file (``tests/test_*.py`` that is not ``test_torch_*``) is in
one of three places:

- collected by its ``tests/test_torch_jax_<stem>.py``, which runs the
  file's text on the port (``test_torch_golden.port_module``) and asserts
  that every case of the file is there;
- collected by one of the files that ran it on the port before those
  (``RUN_BY``);
- in ``NOT_ON_PORT``, with its reason and the port tests that hold its
  cases instead (``HELD_BY``: each of the file's cases, by name, to the
  port test that covers it).

``NOT_ON_PORT_CASES`` names the single cases that a collecting file leaves
out, each with its reason and holder.  A new JAX test file fails
``test_every_jax_test_file_is_placed`` until it is placed.

Tolerance: exact (names).
"""
import ast
import re

from .test_torch_golden import TESTS, text_cases

#: JAX test files run on the port by a file other than their
#: ``test_torch_jax_<stem>.py``: the file (or files) that collect them
RUN_BY = {
    "test_catchup": ("test_torch_catchup",),
    "test_history_catchup": ("test_torch_catchup",),
    "test_chaos": ("test_torch_chaos",),
    "test_detlint": ("test_torch_lint", "test_torch_lint_conc"),
    "test_fuzz": ("test_torch_fuzz",),
    "test_fuzz_schedule": ("test_torch_fuzz",),
    "test_loadgen_rate": ("test_torch_load_generator",),
    "test_lockdep": ("test_torch_lockdep",),
    "test_observatory": ("test_torch_tools_trace",),
    "test_tcp_node": ("test_torch_cli",),
    "test_xdrquery": ("test_torch_cli",),
}

#: JAX test files that do not run on the port: (reason, holders)
NOT_ON_PORT = {
    "test_field25519": ("the module is a rewrite (torch limbs)",
                        ("test_torch_field",)),
    "test_ed25519_kernel": ("the module is a rewrite (the plain torch "
                            "verify beside the CUDA kernel)",
                            ("test_torch_ed25519",)),
    "test_ed25519_edge": ("the module is a rewrite; its Pallas case is the "
                          "CUDA kernel's",
                          ("test_torch_ed25519", "test_torch_kernel_host")),
    "test_admission": ("the module is a rewrite (no jax.sharding)",
                       ("test_torch_admission", "test_torch_parallel")),
    "test_quorum_intersection": ("the module is a rewrite (torch device "
                                 "tier)",
                                 ("test_torch_quorum_intersection",)),
    "test_quorum": ("imports jax.numpy (tests/test_quorum.py:11)",
                    ("test_torch_quorum",)),
    "test_reference_golden": ("its corpus, the reference's tx-meta "
                              "baseline, is absent from the repository",
                              ()),
}

#: each case of a ``NOT_ON_PORT`` file -> ``holder::case`` on the port
HELD_BY = {
    "test_field25519": {
        "test_roundtrip_int_limbs":
        "test_torch_field::test_int_limbs_round_trip_matches_jax",
        "test_add_sub_mul_random":
        "test_torch_field::test_mul_sqr_add_sub_match_jax_and_ints",
        "test_mul_chain_stays_safe":
        "test_torch_field::test_mul_chain_stays_mul_safe",
        "test_freeze_negative_and_redundant":
        "test_torch_field::test_freeze_negative_and_redundant_inputs",
        "test_inv_and_pow22523":
        "test_torch_field::test_inv_and_pow22523_match_ints_and_jax",
        "test_bytes_roundtrip":
        "test_torch_field::test_bytes_round_trip_and_is_zero",
        "test_eq_parity": "test_torch_field::test_equality_and_parity_match_jax",
    },
    "test_ed25519_kernel": {
        "test_kernel_matches_spec": "test_torch_ed25519::test_kernel_case_batch",
        "test_kernel_matches_cpu_backend":
        "test_torch_ed25519::test_kernel_case_batch",
        "test_expected_accept_pattern":
        "test_torch_ed25519::test_kernel_case_batch",
    },
    "test_ed25519_edge": {
        "test_spec_verdicts":
        "test_torch_ed25519::test_plain_verify_edge_vectors_match_spec_and_jax",
        "test_cpu_backend_matches_spec":
        "test_torch_ed25519::test_port_cpu_backend_matches_spec_on_edge_vectors",
        "test_xla_kernel_matches_spec":
        "test_torch_ed25519::test_plain_verify_edge_vectors_match_spec_and_jax",
        "test_pallas_kernel_matches_spec_interpret":
        "test_torch_kernel_host::test_verdicts_on_edge_vectors_match_spec",
        "test_torsion_subgroup_structure":
        "test_torch_ed25519::test_torsion_subgroup_structure",
    },
    "test_admission": {
        "test_dryrun_sharded_8_devices":
        "test_torch_parallel::test_dryrun_multichip_8_equals_jax_admission_step",
        "test_admission_step_matches_host_oracles":
        "test_torch_admission::"
        "test_admission_step_matches_jax_and_rejects_flipped_byte",
        "test_sharded_matches_unsharded":
        "test_torch_parallel::test_dryrun_multichip_8_equals_jax_admission_step",
    },
    "test_quorum_intersection": {
        "TestTarjan": "test_torch_quorum_intersection::TestTarjan",
        "TestChecker": "test_torch_quorum_intersection::TestChecker",
    },
    "test_quorum": {
        "test_is_quorum_slice_matches_reference":
        "test_torch_quorum::test_slice_vblocking_hits_match_jax",
        "test_is_v_blocking_matches_reference":
        "test_torch_quorum::test_slice_vblocking_hits_match_jax",
        "test_contract_to_maximal_quorum":
        "test_torch_quorum::test_contraction_and_is_quorum_match_jax",
        "test_threshold_zero_never_blocks":
        "test_torch_quorum::test_threshold_zero_never_blocks",
        "test_federated_ratify_simple_majority":
        "test_torch_quorum::test_federated_accept_ratify_match_jax",
        "test_federated_ratify_requires_local_slice":
        "test_torch_quorum::test_ratify_requires_local_slice",
        "test_federated_accept_vblocking_path":
        "test_torch_quorum::test_accept_through_v_blocking_path",
        "test_tensor_is_quorum_matches_host_oracle":
        "test_torch_quorum::test_contraction_and_is_quorum_match_jax",
        "test_qset_to_plain_depth_fallback":
        "test_torch_quorum::test_qset_to_plain_depth_fallback",
    },
    "test_reference_golden": {},
}

#: single cases a collecting file leaves out: ``stem::Class::method`` or
#: ``stem::function`` -> (reason, ``holder::case``)
NOT_ON_PORT_CASES = {
    "test_config::TestAutoBackends::"
    "test_auto_resolves_on_application_construction": (
        "monkeypatches utils.device.device_available, the JAX package's "
        "device probe; on the port ``auto`` means the GPU and raises "
        "without one (a kept divergence)",
        "test_torch_node::test_device_backend_without_gpu_raises"),
    "test_native_apply::test_detlint_covers_native_apply_and_kernel_handle": (
        "asserts that the native loader keeps a lock-annotated "
        "``_applykernel_tried`` flag; the port's getters raise on a failed "
        "build and keep no such flag (a kept divergence)",
        "test_torch_lint::test_native_handles_are_lock_annotated"),
}


def left_out(stem: str) -> tuple:
    """The cases of ``tests/<stem>.py`` that its collecting file leaves
    out (``NOT_ON_PORT_CASES``), as ``_port_tests`` takes them."""
    return tuple(case.partition("::")[2] for case in NOT_ON_PORT_CASES
                 if case.partition("::")[0] == stem)


def _jax_stems() -> list:
    return sorted(p.stem for p in TESTS.glob("test_*.py")
                  if not p.stem.startswith("test_torch_"))


def _defines(stem: str, case: str) -> bool:
    """``tests/<stem>.py`` defines ``case`` (``name`` or
    ``Class::method``) at its top level."""
    body = ast.parse((TESTS / f"{stem}.py").read_text()).body
    name, _, method = case.partition("::")
    for node in body:
        if getattr(node, "name", None) == name:
            return not method or any(getattr(n, "name", None) == method
                                     for n in node.body)
    return False


def test_every_jax_test_file_is_placed():
    stems = _jax_stems()
    assert len(stems) == 57
    places = {}
    for stem in stems:
        own = (TESTS / f"test_torch_jax_{stem[len('test_'):]}.py").is_file()
        places[stem] = [where for where, yes in (
            ("own", own), ("run_by", stem in RUN_BY),
            ("not_on_port", stem in NOT_ON_PORT)) if yes]
    assert {s: p for s, p in places.items() if len(p) != 1} == {}
    assert set(RUN_BY) | set(NOT_ON_PORT) <= set(stems)
    collecting = {p.stem[len("test_torch_jax_"):]
                  for p in TESTS.glob("test_torch_jax_*.py")} - {"files"}
    assert {f"test_{s}" for s in collecting} <= set(stems)


def test_run_by_files_execute_the_jax_file():
    for stem, holders in RUN_BY.items():
        text = "".join((TESTS / f"{h}.py").read_text() for h in holders)
        assert f'TESTS / "{stem}.py"' in text or \
            f'port_module("{stem}")' in text, stem


def test_collecting_files_import_nothing_of_the_jax_package():
    for path in sorted(TESTS.glob("test_torch_jax_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if re.match(
                r"(jax|stellar_core_tpu|tools)(\.|$)", n)], path.name


def test_not_on_port_files_are_held_case_by_case():
    for stem, (reason, holders) in NOT_ON_PORT.items():
        assert reason, stem
        assert all((TESTS / f"{h}.py").is_file() for h in holders), stem
        assert set(HELD_BY[stem]) == (text_cases(TESTS / f"{stem}.py")
                                      if holders else set()), stem
        for case, held in HELD_BY[stem].items():
            holder, _, name = held.partition("::")
            assert holder in holders, (stem, case)
            assert _defines(holder, name), held
            if case.startswith("Test"):   # a class: method by method
                cls = next(n for n in ast.parse((TESTS / f"{stem}.py")
                                                .read_text()).body
                           if getattr(n, "name", None) == case)
                for m in cls.body:
                    if getattr(m, "name", "").startswith("test_"):
                        assert _defines(holder, f"{name}::{m.name}"), \
                            (stem, case, m.name)
    assert set(HELD_BY) == set(NOT_ON_PORT)


def test_not_on_port_cases_name_real_cases_and_holders():
    assert len(NOT_ON_PORT_CASES) == 2
    for case, (reason, held) in NOT_ON_PORT_CASES.items():
        stem, _, name = case.partition("::")
        assert reason and _defines(stem, name), case
        assert (TESTS / f"test_torch_jax_{stem[len('test_'):]}.py"
                ).is_file(), case
        holder, _, hname = held.partition("::")
        assert _defines(holder, hname), held
