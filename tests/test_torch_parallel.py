"""The port's data-parallel admission (``parallel``, the sharded functions of
``models/admission.py`` and ``entry.py``) held against its unsharded step
and against the JAX package's ``admission_step`` and
``multi_validator_tally`` on the same inputs (the JAX side jitted on the
CPU as ``tests/test_admission.py`` runs it).  Devices are CPU chunks: the
signature batch split into 8 contiguous chunks, the quorum tensors
replicated, the validator axis of the ballot tally split.

Tolerance: exact equality of every boolean.
"""
import jax
import numpy as np
import pytest
import torch

from stellar_core_tpu.models import admission as JA
from stellar_core_tpu.ops import quorum as JQ
from stellar_core_tpu_torch import entry
from stellar_core_tpu_torch.models import admission as A
from stellar_core_tpu_torch.parallel import (DATA_AXIS, data_parallel_devices,
                                             dp, replicated)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def dryrun():
    """``dryrun_multichip(8)``: 16 signatures over 8 CPU chunks (it raises
    unless each sharded result equals the unsharded step)."""
    return entry.dryrun_multichip(8)


def test_dryrun_multichip_8_equals_jax_admission_step(dryrun):
    (jb,) = JA.example_batch(n_sigs=16, n_nodes=4)
    want = jax.jit(JA.admission_step)(jb)
    assert dryrun["sig_ok"].shape == (16,) and bool(dryrun["sig_ok"].all())
    for key, w in zip(("sig_ok", "accept", "ratify"), want):
        np.testing.assert_array_equal(dryrun[key].numpy(), np.asarray(w))


def test_dryrun_multichip_8_tally_equals_jax_multi_validator_tally(dryrun):
    n = 32   # 4 validators a device
    nodes = list(range(n))
    qt = JQ.build_qset_tensor([(n - n // 3, nodes, []) for _ in nodes], nodes)
    rng = np.random.default_rng(11)
    voted = rng.random((8, n)) < 0.8
    accepted = rng.random((8, n)) < 0.5
    acc, rat = jax.jit(JA.multi_validator_tally)(qt, voted, accepted)
    np.testing.assert_array_equal(dryrun["tally_accept"].numpy(),
                                  np.asarray(acc))
    np.testing.assert_array_equal(dryrun["tally_ratify"].numpy(),
                                  np.asarray(rat))


def test_sharded_step_rejects_a_flipped_byte_in_its_chunk():
    """A forged row in the second chunk is refused there, and only there."""
    (batch,) = A.example_batch(n_sigs=8, n_nodes=4, device="cpu")
    sigs = batch.sigs.clone()
    sigs[7, 0] ^= 0xFF
    bad = batch._replace(sigs=sigs)
    got = A.sharded_admission_step(bad, [torch.device("cpu")] * 2)
    for g, w in zip(got, A.admission_step(bad)):
        assert torch.equal(g, w)
    assert got[0].tolist() == [True] * 7 + [False]


def test_layout_helpers():
    assert DATA_AXIS == "data"
    x = torch.arange(10)
    chunks = dp(x, CPU8)
    assert [c.tolist() for c in chunks] == [[0, 1], [2, 3], [4], [5], [6],
                                            [7], [8], [9]]
    assert all(torch.equal(r, x) for r in replicated(x, CPU8[:3]))
    assert data_parallel_devices(3, CPU8) == CPU8[:3]
    assert data_parallel_devices(devices=["cpu"]) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        data_parallel_devices(9, CPU8)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_default_devices_are_the_gpus_and_none_raises():
    with pytest.raises(ValueError, match="no CUDA device"):
        data_parallel_devices()
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        A.bench_sharded(1, n_sigs=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def test_entry_on_the_cpu_equals_jax():
    """``entry`` gives the port's step and the JAX ``entry``'s batch (the
    step itself is held against the JAX one in test_torch_admission)."""
    fn, (batch,) = entry.entry(device="cpu")
    assert fn is A.admission_step
    (jb,) = JA.example_batch(n_sigs=8, n_nodes=4)
    for field in ("pubkeys", "sigs", "msgs", "voted", "accepted"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jb, field)))
    for g, w in zip((*batch.qset, *batch.local_qset),
                    (*jb.qset, *jb.local_qset)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bench_sharded_512_from_workload_npz(tmp_path):
    """512 signatures from a workload file on one CPU device: the JAX
    ``bench_sharded``'s keys, every verdict true (it asserts so)."""
    from stellar_core_tpu_torch.crypto import SecretKey, sha256

    n = 512
    keys = [SecretKey(sha256(b"npz%d" % i)) for i in range(16)]
    rng = np.random.default_rng(5)
    mg = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    pk = np.stack([np.frombuffer(keys[i % 16].public_key().raw, np.uint8)
                   for i in range(n)])
    sg = np.stack([np.frombuffer(keys[i % 16].sign(bytes(mg[i])), np.uint8)
                   for i in range(n)])
    path = tmp_path / "workload.npz"
    np.savez(path, pk=pk, sg=sg, mg=mg)
    res = A.bench_sharded(n_sigs=n, workload_npz=str(path), n_validators=16,
                          n_candidates=8, devices=["cpu"])
    assert set(res) == {
        "n_devices", "device_kind", "platform", "n_signatures",
        "verify_compile_s", "verify_step_s", "verify_sigs_per_s",
        "verify_sigs_per_s_per_device", "n_validators", "n_candidates",
        "tally_compile_s", "tally_step_s", "validator_tallies_per_s"}
    assert (res["n_devices"], res["platform"], res["device_kind"],
            res["n_signatures"], res["n_validators"]) == (1, "cpu", "cpu",
                                                          n, 16)
