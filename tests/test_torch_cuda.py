"""Tests of the hand-written CUDA kernels, which run only on the card: each
kernel against its plain torch version and the spec, its launch count,
and the wrapper's input checks.  They import only torch, numpy and the
port (the GPU host has no jax) and skip with a reason where there is no
GPU.  On a GPU host, without the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: exact equality of every verdict."""
import numpy as np
import pytest
import torch

from chip_smoke import SPECIAL_SCALARS, check_double_scalar, edge_vectors
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.ops import ed25519_cuda
from stellar_core_tpu_torch.ops import ed25519_kernel as K


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _rows():
    """The 26 edge vectors plus 16 signed rows, every other one forged."""
    pk, sg, mg = edge_vectors(ref, sha256)
    rng = np.random.default_rng(31)
    extra = []
    for i in range(16):
        seed = sha256(b"cuda-test%d" % (i % 4))
        msg = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        sig = bytearray(ref.sign(seed, msg))
        if i % 2:
            sig[i] ^= 0x04
        extra.append((ref.public_from_seed(seed), bytes(sig), msg))
    cols = [np.frombuffer(b"".join(r[j] for r in extra), np.uint8).reshape(
        len(extra), w) for j, w in enumerate((32, 64, 32))]
    return [np.concatenate([a, b]) for a, b in zip((pk, sg, mg), cols)]


@pytest.mark.cuda
def test_ed25519_kernel_matches_plain_version_and_spec():
    _need_gpu()
    pk, sg, mg = (torch.from_numpy(x).cuda() for x in _rows())
    before = ed25519_cuda.launches
    got = ed25519_cuda.verify_batch(pk, sg, mg)
    assert ed25519_cuda.launches == before + 1
    assert torch.equal(got, K.verify_batch(pk, sg, mg))
    host = [t.cpu().numpy() for t in (pk, sg, mg)]
    want = [ref.verify(host[0][i].tobytes(), host[1][i].tobytes(),
                       host[2][i].tobytes()) for i in range(got.shape[0])]
    assert got.tolist() == want
    assert 0 < sum(want) < len(want)


@pytest.mark.cuda
def test_ed25519_kernel_takes_unaligned_rows():
    """The kernel reads rows as 16-byte vectors; a contiguous view whose
    base is not 16-byte aligned is copied by the wrapper, same verdicts."""
    _need_gpu()
    cols = _rows()
    want = ed25519_cuda.verify_batch(*(torch.from_numpy(x).cuda()
                                       for x in cols))
    views = []
    for x in cols:
        flat = torch.zeros(x.size + 8, dtype=torch.uint8, device="cuda")
        view = flat[8:].view(x.shape)
        view.copy_(torch.from_numpy(x))
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        views.append(view)
    assert torch.equal(ed25519_cuda.verify_batch(*views), want)


@pytest.mark.cuda
def test_double_scalar_entry_matches_spec_on_special_scalars():
    """The PTX carry chains and the signed recoding on the card: the
    test-only entry's [s]B + [h](-A) against the spec, not counted as a
    launch of the verify kernel."""
    _need_gpu()
    before = ed25519_cuda.launches
    n = check_double_scalar(ref, ed25519_cuda, np.random.default_rng(7),
                            torch.device("cuda"))
    assert n == 3 * len(SPECIAL_SCALARS)
    assert ed25519_cuda.launches == before


@pytest.mark.cuda
def test_integer_matmul_is_missing_on_card():
    """Why the plain versions use multiply-and-sum: torch has no integer
    GEMM on CUDA (the JAX package's bits@matrix, digest@POW8 and quorum
    einsums would not run there)."""
    _need_gpu()
    a = torch.ones(4, 4, dtype=torch.int32, device="cuda")
    for f in (lambda: a @ a, lambda: a.long() @ a.long(),
              lambda: torch.einsum("ij,jk->ik", a, a)):
        with pytest.raises(NotImplementedError):
            f()


@pytest.mark.cuda
def test_ed25519_wrapper_checks_inputs_on_card():
    _need_gpu()
    pk, sg, mg = (torch.from_numpy(x).cuda() for x in _rows())
    before = ed25519_cuda.launches
    empty = ed25519_cuda.verify_batch(pk[:0], sg[:0], mg[:0])
    assert empty.shape == (0,) and ed25519_cuda.launches == before
    with pytest.raises(ValueError, match="uint8"):
        ed25519_cuda.verify_batch(pk.to(torch.int32), sg, mg)
    with pytest.raises(ValueError, match="sigs"):
        ed25519_cuda.verify_batch(pk, sg[:, :32].contiguous(), mg)
    with pytest.raises(ValueError, match="contiguous"):
        ed25519_cuda.verify_batch(pk, sg, torch.cat([mg, mg], 1)[:, ::2])
    with pytest.raises(ValueError, match="one device"):
        ed25519_cuda.verify_batch(pk, sg, mg.cpu())
    assert ed25519_cuda.launches == before
