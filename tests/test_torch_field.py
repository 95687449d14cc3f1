"""The port's limb layer (field25519 / scalar25519 / sha512) against the
JAX package's functions and against Python ints / hashlib, on seeded
numpy inputs.  Tolerance: exact equality (integer arithmetic)."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stellar_core_tpu.ops import field25519 as JF
from stellar_core_tpu.ops import scalar25519 as JS
from stellar_core_tpu.ops.sha512 import sha512_96 as jax_sha512_96
from stellar_core_tpu_torch.ops import field25519 as F
from stellar_core_tpu_torch.ops import scalar25519 as S
from stellar_core_tpu_torch.ops.sha512 import sha512_96

P = F.P
L = S.L


def _rand_ints(rng, n, bound=P):
    return [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]


def _limbs(vals):
    return np.stack([F.int_to_limbs(v) for v in vals])


def _mul_safe_limbs(rng, n):
    """Redundant signed limbs inside the mul-safe bounds."""
    x = rng.integers(-F.MUL_SAFE, F.MUL_SAFE + 1, (n, F.NLIMBS),
                     dtype=np.int64)
    x[:, 0] = rng.integers(-F.MUL_SAFE_0, F.MUL_SAFE_0 + 1, n)
    return x.astype(np.int32)


def _ints(limbs):
    return [F.limbs_to_int(r) for r in np.asarray(limbs)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mul_sqr_add_sub_match_jax_and_ints(seed):
    rng = np.random.default_rng(seed)
    a, b = _mul_safe_limbs(rng, 16), _mul_safe_limbs(rng, 16)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name, got, want, ref in (
        ("mul", F.mul(ta, tb), JF.mul(jnp.asarray(a), jnp.asarray(b)),
         lambda x, y: x * y),
        ("add", F.add(ta, tb), JF.add(jnp.asarray(a), jnp.asarray(b)),
         lambda x, y: x + y),
        ("sub", F.sub(ta, tb), JF.sub(jnp.asarray(a), jnp.asarray(b)),
         lambda x, y: x - y),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        assert _ints(got) == [ref(x, y) % P for x, y in
                              zip(_ints(a), _ints(b))], name
    np.testing.assert_array_equal(F.sqr(ta).numpy(),
                                  np.asarray(JF.sqr(jnp.asarray(a))))


def test_mul_chain_stays_mul_safe():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_mul_safe_limbs(rng, 8))
    want = _ints(x)
    for _ in range(40):
        x = F.mul(x, x)
        want = [v * v % P for v in want]
        assert int(x[:, 1:].abs().max()) <= F.MUL_SAFE
        assert int(x[:, 0].abs().max()) <= F.MUL_SAFE_0
    assert _ints(x) == want


def test_inv_and_pow22523_match_ints_and_jax():
    rng = np.random.default_rng(3)
    vals = _rand_ints(rng, 6) + [0, 1, P - 1]
    x = _limbs(vals)
    inv = F.inv(torch.from_numpy(x))
    p22 = F.pow22523(torch.from_numpy(x))
    assert _ints(inv) == [pow(v, P - 2, P) for v in vals]
    assert _ints(p22) == [pow(v, (P - 5) // 8, P) for v in vals]
    np.testing.assert_array_equal(
        F.freeze(inv).numpy(), np.asarray(JF.freeze(JF.inv(jnp.asarray(x)))))


def test_freeze_negative_and_redundant_inputs():
    rng = np.random.default_rng(4)
    x = _mul_safe_limbs(rng, 32)
    got = F.freeze(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.freeze(jnp.asarray(x))))
    assert (got >= 0).all() and (got <= F.MASK).all()
    assert [sum(int(l) << (12 * i) for i, l in enumerate(r)) for r in got] \
        == _ints(x)
    # p and p + 1, unreduced in limb form, freeze to 0 and 1
    edge = np.stack([[(v >> (12 * i)) & F.MASK for i in range(F.NLIMBS)]
                     for v in (P, P + 1)]).astype(np.int32)
    frozen = F.freeze(torch.from_numpy(edge)).numpy()
    np.testing.assert_array_equal(frozen, _limbs([0, 1]))


def test_bytes_round_trip_and_is_zero():
    rng = np.random.default_rng(5)
    vals = _rand_ints(rng, 12)
    enc = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                    for v in vals])
    limbs = F.from_bytes(torch.from_numpy(enc))
    np.testing.assert_array_equal(
        limbs.numpy(), np.asarray(JF.from_bytes(jnp.asarray(enc))))
    assert _ints(limbs) == vals
    np.testing.assert_array_equal(F.to_bytes(limbs).numpy(), enc)
    assert not F.is_zero(limbs).any() and F.is_zero(limbs - limbs).all()


def test_reduce512_matches_ints_and_jax():
    rng = np.random.default_rng(6)
    dig = rng.integers(0, 256, (24, 64), dtype=np.uint8)
    dig[0] = 255
    dig[1] = 0
    got = S.reduce512(torch.from_numpy(dig))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.reduce512(jnp.asarray(dig))))
    assert [sum(int(l) << (12 * i) for i, l in enumerate(r))
            for r in got.numpy()] == \
        [int.from_bytes(d.tobytes(), "little") % L for d in dig]


def test_is_canonical_and_digits():
    rng = np.random.default_rng(7)
    vals = _rand_ints(rng, 8, 1 << 256) + [L - 1, L, L + 1, 0]
    enc = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                    for v in vals])
    got = S.is_canonical(torch.from_numpy(enc))
    assert got.tolist() == [v < L for v in vals]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.is_canonical(jnp.asarray(enc))))
    small = [v % L for v in vals]
    digits = S.to_digits4(torch.from_numpy(_limbs_w(small))).numpy()
    for v, d in zip(small, digits):
        assert sum(int(x) << (4 * i) for i, x in enumerate(d)) == v
    np.testing.assert_array_equal(
        digits, np.asarray(JS.to_digits4(jnp.asarray(_limbs_w(small)))))


def _limbs_w(vals):
    return np.stack([S._int_to_limbs_w(v, F.NLIMBS) for v in vals])


def test_sha512_96_matches_hashlib_and_jax():
    rng = np.random.default_rng(8)
    msg = rng.integers(0, 256, (16, 96), dtype=np.uint8)
    msg[0] = 0
    msg[1] = 255
    got = sha512_96(torch.from_numpy(msg)).numpy()
    for m, d in zip(msg, got):
        assert d.tobytes() == hashlib.sha512(m.tobytes()).digest()
    np.testing.assert_array_equal(got, np.asarray(jax_sha512_96(
        jnp.asarray(msg))))


def test_int_limbs_round_trip_matches_jax():
    """tests/test_field25519.py::test_roundtrip_int_limbs on the port's
    limbs, which equal the JAX package's."""
    rng = np.random.default_rng(1)
    edge = [0, 1, 2, 19, P - 1, P - 2, P - 19, 2**255 - 19 - 1, 2**252, 7]
    for v in edge + _rand_ints(rng, 20):
        np.testing.assert_array_equal(F.int_to_limbs(v), JF.int_to_limbs(v))
        assert F.limbs_to_int(F.int_to_limbs(v)) == v % P


def test_equality_and_parity_match_jax():
    """tests/test_field25519.py::test_eq_parity on the port, which has no
    ``eq`` or ``parity`` of its own: equality is ``is_zero`` of the
    difference, parity is bit 0 of the canonical bytes."""
    x, y = _limbs([5, P - 5, 5, 0, 1]), _limbs([5, 5, P - 5, 0, P - 1])
    got = F.is_zero(F.sub(torch.from_numpy(x), torch.from_numpy(y)))
    assert got.tolist() == [True, False, False, True, False]
    assert got.tolist() == np.asarray(JF.eq(jnp.asarray(x),
                                            jnp.asarray(y))).tolist()
    z = _limbs([2, 3, P - 1, P - 2])
    par = F.to_bytes(torch.from_numpy(z))[:, 0] & 1
    assert par.tolist() == [0, 1, (P - 1) & 1, (P - 2) & 1]
    assert par.tolist() == np.asarray(JF.parity(jnp.asarray(z))).tolist()
