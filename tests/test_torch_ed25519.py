"""The port's ed25519 verify against the JAX package: the plain torch
version (``ops/ed25519_kernel``) and the kernel wrapper's CPU dispatch
(``ops/ed25519_cuda``) must give the spec's verdicts on the 26 libsodium
edge vectors, agree with the JAX XLA verify there, and agree with the CPU
backend on a seeded mixed batch.  The kernel's generated constants are
checked against the spec here; the kernel itself runs only on the card
(tests/test_torch_cuda.py).  Tolerance: exact equality of every verdict."""
import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto import SecretKey, sha256
from stellar_core_tpu.crypto import ed25519 as cpu_ed
from stellar_core_tpu.crypto import ed25519_ref as jref
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.ops import ed25519_cuda
from stellar_core_tpu_torch.ops import ed25519_kernel as K
from tests.test_ed25519_edge import VECTORS


def _arrays(rows):
    n = len(rows)
    return [np.frombuffer(b"".join(r[i] for r in rows), np.uint8).reshape(
        n, w).copy() for i, w in enumerate((32, 64, 32))]


def _mixed_batch(seed=11, n=64):
    """n rows from 8 keys; rows 1, 5, 9, ... have a flipped sig byte, rows
    3, 7, 11, ... a flipped msg byte."""
    rng = np.random.default_rng(seed)
    keys = [SecretKey(sha256(b"torch-mixed%d" % k)) for k in range(8)]
    rows = []
    for i in range(n):
        sk = keys[i % 8]
        msg = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        sig = sk.sign(msg)
        if i % 4 == 1:
            j = int(rng.integers(0, 64))
            sig = sig[:j] + bytes([sig[j] ^ 0x10]) + sig[j + 1:]
        elif i % 4 == 3:
            msg = msg[:5] + bytes([msg[5] ^ 1]) + msg[6:]
        rows.append((sk.public_key().raw, sig, msg))
    return rows


def test_spec_copy_matches_jax_spec():
    for name in ("P", "L", "D", "SQRT_M1", "B", "SMALL_ORDER_ENCODINGS"):
        assert getattr(ref, name) == getattr(jref, name), name
    seed, msg = sha256(b"copy"), sha256(b"copy-msg")
    assert ref.sign(seed, msg) == jref.sign(seed, msg)
    assert ref.public_from_seed(seed) == jref.public_from_seed(seed)


def test_plain_verify_edge_vectors_match_spec_and_jax():
    from stellar_core_tpu.ops.ed25519_kernel import verify_batch as jax_vb

    pk, sg, mg = _arrays(VECTORS)
    got = K.verify_batch(*(torch.from_numpy(x) for x in (pk, sg, mg)))
    jax_got = np.asarray(jax_vb(pk, sg, mg))
    np.testing.assert_array_equal(got.numpy(), jax_got)
    for (pkb, sig, msg, label), g in zip(VECTORS, got.tolist()):
        assert g == jref.verify(pkb, sig, msg) == ref.verify(pkb, sig, msg), \
            label


def test_wrapper_dispatches_cpu_tensors_to_plain_version():
    pk, sg, mg = (torch.from_numpy(x) for x in _arrays(VECTORS))
    before = ed25519_cuda.launches
    got = ed25519_cuda.verify_batch(pk, sg, mg)
    assert ed25519_cuda.launches == before   # no kernel launch on the CPU
    assert got.tolist() == [label == "valid" for *_, label in VECTORS]
    # numpy input with an explicit CPU device takes the same route
    got_np = ed25519_cuda.verify_batch(*_arrays(VECTORS), device="cpu")
    assert torch.equal(got_np, got)


def test_mixed_batch_matches_cpu_backend():
    rows = _mixed_batch()
    got = K.verify_batch(*(torch.from_numpy(x) for x in _arrays(rows)))
    want = [cpu_ed.raw_verify(*r) for r in rows]
    assert got.tolist() == want
    assert sum(want) == len(rows) // 2


def test_decompress_encode_round_trip():
    rows = _mixed_batch(seed=12, n=8)
    enc = [r[0] for r in rows] + [r[1][:32] for r in rows] + [
        int.to_bytes(ref.P + 1, 32, "little"), ref.SMALL_ORDER_ENCODINGS[0]]
    t = torch.from_numpy(np.frombuffer(b"".join(enc), np.uint8).reshape(
        len(enc), 32).copy())
    pt, ok = K.decompress(t)
    assert ok.tolist() == [ref.decode_point(e) is not None for e in enc]
    back = K.encode(pt)
    for e, o, b in zip(enc, ok.tolist(), back.numpy()):
        if o:
            assert b.tobytes() == e


def _val(words):
    """Little-endian 32-bit words -> int."""
    return sum(w << (32 * i) for i, w in enumerate(words))


@pytest.mark.parametrize("v", [0, 1, ref.D, 2 * ref.D, ref.SQRT_M1,
                               ref.P - 1, ref.P, ref.P + 5])
def test_kernel_constants_header_matches_spec(v):
    """The generated header's 8-limb constants decode back to the spec's
    values (canonical, below p), and every constant the kernel reads is
    in the header."""
    words = ed25519_cuda.fe8(v)
    assert len(words) == 8 and all(0 <= w < 2**32 for w in words)
    assert _val(words) == v % ref.P
    text = ed25519_cuda.consts_header()
    for name, value in (("ED_D", ref.D), ("ED_D2", 2 * ref.D % ref.P),
                        ("ED_SQRTM1", ref.SQRT_M1)):
        body = text.split(f" {name}[8] = {{")[1].split("}")[0]
        assert _val([int(x.rstrip("u"), 16) for x in body.split(",")]) \
            == value, name
    for name in ("ED_BTAB", "ED_SMALL_ORDER", "ED_L_WORDS", "ED_POW8",
                 "ED_LSHIFT", "SHA512_K", "SHA512_IV"):
        assert f" {name}[" in text, name


def test_kernel_niels_table_decodes_to_multiples_of_b():
    """Entry k-1 of the niels table (y + x, y - x, 2dxy) is the spec's
    [k]B for k = 1..8."""
    tab = ed25519_cuda._b_table()
    assert len(tab) == 8
    inv2 = pow(2, ref.P - 2, ref.P)
    pt = ref.IDENT
    for k in range(1, 9):
        pt = ref.point_add(pt, ref.to_extended(ref.B))
        ypx, ymx, xy2d = (_val(c) for c in tab[k - 1])
        y, x = (ypx + ymx) * inv2 % ref.P, (ypx - ymx) * inv2 % ref.P
        assert ref.encode_point((x, y, 1, x * y % ref.P)) == \
            ref.encode_point(pt), k
        assert xy2d == 2 * ref.D * x * y % ref.P, k


def test_double_scalar_entry_takes_only_cuda_tensors():
    """The test-only double-scalar entry has no plain version to fall back
    on: CPU tensors raise."""
    z = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ed25519_cuda.double_scalar(z, z, z)
