"""The port's admission step against the JAX package's, fed identical numpy
inputs through ``batch_from_numpy``; plus the one-flipped-byte rejection,
``multi_validator_tally`` on a seeded 2-level topology, and the
signature-batch buckets, and the pinned small-order divergence from the JAX
``admission_step``.  Tolerance: exact equality of every boolean."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_core_tpu.models import admission as JA
from stellar_core_tpu.ops import quorum as JQ
from stellar_core_tpu.utils import device as jdevice
from stellar_core_tpu_torch.models import admission as A
from stellar_core_tpu_torch.ops import quorum as Q
from stellar_core_tpu_torch.utils import device as tdevice


def _from_jax(batch):
    """The JAX batch's fields as numpy, into the port (on the CPU)."""
    return A.batch_from_numpy(
        *(np.asarray(x) for x in (batch.pubkeys, batch.sigs, batch.msgs)),
        [np.asarray(t) for t in batch.qset],
        [np.asarray(t) for t in batch.local_qset],
        np.asarray(batch.voted), np.asarray(batch.accepted), device="cpu")


def _assert_same(port_out, jax_out):
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_admission_step_matches_jax_and_rejects_flipped_byte():
    (jb,) = JA.example_batch(n_sigs=8, n_nodes=4)
    want = jax.jit(JA.admission_step)(jb)
    got = A.admission_step(_from_jax(jb))
    _assert_same(got, want)
    assert got[0].all()

    bad_sigs = np.asarray(jb.sigs).copy()
    bad_sigs[0, 0] ^= 0xFF
    jbad = jb._replace(sigs=jnp.asarray(bad_sigs))
    got_bad = A.admission_step(_from_jax(jbad))
    _assert_same(got_bad, jax.jit(JA.admission_step)(jbad))
    assert not bool(got_bad[0][0]) and got_bad[0][1:].all()


def test_small_order_key_divergence_from_jax_admission_step():
    """A row whose A is the identity encoding (small order) and whose
    signature is R = [s]B: the cofactorless equation [s]B + [h](-A) = R
    holds, so only the small-order blacklist refuses it.  The port's
    ``admission_step`` applies the blacklist (0), as the spec and the JAX
    ``ops/ed25519_kernel.verify_batch`` do.  The JAX ``admission_step``
    gives 1: it calls ``_verify_impl`` directly
    (``stellar_core_tpu/models/admission.py:45``), which lacks the
    blacklist that ``verify_batch`` adds around it."""
    from stellar_core_tpu.crypto import ed25519_ref as jref
    from stellar_core_tpu.ops.ed25519_kernel import verify_batch as jax_vb

    (jb,) = JA.example_batch(n_sigs=8, n_nodes=4)
    ident = (1).to_bytes(32, "little")
    assert ident in jref.SMALL_ORDER_ENCODINGS
    s = int.from_bytes(hashlib.sha512(b"small-order-s").digest(),
                       "little") % jref.L
    sig = jref.encode_point(jref.scalar_mult_base(s)) + s.to_bytes(32,
                                                                  "little")
    pk, sg = np.asarray(jb.pubkeys).copy(), np.asarray(jb.sigs).copy()
    pk[0], sg[0] = np.frombuffer(ident, np.uint8), np.frombuffer(sig, np.uint8)
    jbad = jb._replace(pubkeys=jnp.asarray(pk), sigs=jnp.asarray(sg))

    got = A.admission_step(_from_jax(jbad))[0].numpy()
    jax_step = np.asarray(jax.jit(JA.admission_step)(jbad)[0])
    jax_vb_out = np.asarray(jax_vb(pk, sg, np.asarray(jb.msgs)))
    spec = jref.verify(ident, sig, np.asarray(jb.msgs)[0].tobytes())
    assert not spec and not got[0] and not jax_vb_out[0]
    assert jax_step[0]                  # the known divergence
    assert got[1:].all() and jax_step[1:].all() and jax_vb_out[1:].all()


def test_example_batch_is_the_jax_example_batch():
    (jb,) = JA.example_batch(n_sigs=16, n_nodes=4)
    (tb,) = A.example_batch(n_sigs=16, n_nodes=4, device="cpu")
    for name in ("pubkeys", "sigs", "msgs", "voted", "accepted"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for q, jq in ((tb.qset, jb.qset), (tb.local_qset, jb.local_qset)):
        for p, j in zip(q, jq):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def _org_topology(rng, n_orgs=4, org_size=3):
    """Seeded 2-level org topology: every node needs ``top`` of the org
    inner sets (each 2 of 3), a few nodes also list single validators."""
    orgs = [list(range(o * org_size, (o + 1) * org_size))
            for o in range(n_orgs)]
    qsets = []
    for i in range(n_orgs * org_size):
        extra = sorted(int(v) for v in rng.choice(n_orgs * org_size,
                                                  int(rng.integers(0, 2)),
                                                  replace=False))
        top = int(rng.integers(2, n_orgs + 1))
        qsets.append((top, extra, [(2, org) for org in orgs]))
    return qsets


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_validator_tally_matches_jax(seed):
    rng = np.random.default_rng(seed)
    qsets = _org_topology(rng)
    nodes = list(range(len(qsets)))
    rate = rng.uniform(0.3, 1.0, (12, 1))
    voted = rng.random((12, len(nodes))) < rate
    accepted = rng.random((12, len(nodes))) < rate * 0.4
    jt = JQ.build_qset_tensor(qsets, nodes)
    tt = Q.build_qset_tensor(qsets, nodes, device="cpu")
    want = JA.multi_validator_tally(jt, jnp.asarray(voted),
                                    jnp.asarray(accepted))
    got = A.multi_validator_tally(tt, torch.from_numpy(voted),
                                  torch.from_numpy(accepted))
    _assert_same(got, want)
    assert 0 < int(got[1].sum()) < got[1].numel()   # a mix of verdicts


def test_signature_buckets_are_the_jax_buckets():
    assert tdevice.SIG_BATCH_BUCKETS == jdevice.SIG_BATCH_BUCKETS
    for n in (0, 1, 255, 256, 257, 100_000, 131_072, 131_073, 400_000):
        assert tdevice.pad_signature_batch(n) == jdevice.pad_signature_batch(n)


def test_default_device_raises_without_gpu():
    assert tdevice.default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdevice.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            A.example_batch(n_sigs=1, n_nodes=4)
