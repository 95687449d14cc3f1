"""Batched ed25519 verification as plain torch ops — the plain version of
the hand-written CUDA kernel in ``ops/ed25519_cuda.py``.

Counterpart of the JAX package's XLA tier, step for step:
  1. decode A (pubkey) and R (sig[0:32]) — batched square-root decompression;
  2. h = SHA-512(R || A || M) mod L  (ops/sha512.py + ops/scalar25519.py);
  3. R' = [s]B + [h](-A) via a shared-doubling ladder with 4-bit windows:
     a constant 16-entry table for B and a per-signature table for -A,
     selected by one-hot multiply-and-sum (no integer matmul: torch has no
     integer GEMM on CUDA, and this module runs on the card as the
     kernel's plain version);
  4. accept iff encode(R') == sig[0:32], s < L, both decodes succeeded and
     neither A nor R is a small-order encoding.

Acceptance semantics are the spec's (``crypto/ed25519_ref.verify``,
libsodium crypto_sign_verify_detached).  Messages are 32 bytes: stellar
signatures cover a SHA-256 content hash.  Scans become Python loops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from ..utils.device import cpu_threads
from . import field25519 as F
from . import scalar25519 as S
from .sha512 import sha512_96

I32 = torch.int32

_D = F.int_to_limbs(ref.D)
_D2 = F.int_to_limbs(2 * ref.D % F.P)
_SQRT_M1 = F.int_to_limbs(ref.SQRT_M1)


def _c(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(limbs, device=like.device)


def _ident(shape, device):
    zero = F.zeros(shape, device)
    one = F.const(1, shape, device)
    return (zero, one, one, zero)


def _table_np() -> np.ndarray:
    """Constant table [0..15]*B as (16, 4, 22) int32, affine with Z=1."""
    rows = []
    pt = ref.IDENT
    for _ in range(16):
        x, y, z, _t = pt
        zi = pow(z, F.P - 2, F.P)
        xa, ya = x * zi % F.P, y * zi % F.P
        rows.append(np.stack([F.int_to_limbs(xa), F.int_to_limbs(ya),
                              F.int_to_limbs(1), F.int_to_limbs(xa * ya % F.P)]))
        pt = ref.point_add(pt, ref.to_extended(ref.B))
    return np.stack(rows)


_B_TABLE = _table_np()

_SMALL_ORDER_NP = np.frombuffer(
    b"".join(ref.SMALL_ORDER_ENCODINGS), dtype=np.uint8
).reshape(len(ref.SMALL_ORDER_ENCODINGS), 32).copy()


# ---------------------------------------------------------------------------
# point ops (extended twisted Edwards coordinates, unified add)
# ---------------------------------------------------------------------------

def point_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul(F.sub(y1, x1), F.sub(y2, x2))
    b = F.mul(F.add(y1, x1), F.add(y2, x2))
    c = F.mul(F.mul(t1, t2), _c(_D2, x1))
    d = F.mul(z1, z2)
    d = F.add(d, d)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_double(p):
    x1, y1, z1, _ = p
    a = F.mul(x1, x1)
    b = F.mul(y1, y1)
    zz = F.mul(z1, z1)
    c = F.add(zz, zz)
    h = F.add(a, b)
    xy = F.add(x1, y1)
    e = F.sub(h, F.mul(xy, xy))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_neg(p):
    x, y, z, t = p
    return (F.weak_carry(-x), y, z, F.weak_carry(-t))


def _select(table, digit):
    """table: 4 tensors (..., 16, 22) or (16, 22); digit (...,) in [0, 16)
    -> 4 tensors (..., 22), by one-hot multiply-and-sum."""
    w = torch.arange(16, dtype=I32, device=digit.device)
    onehot = (digit[..., None] == w).to(I32)[..., None]       # (..., 16, 1)
    return tuple((onehot * coord).sum(dim=-2, dtype=I32) for coord in table)


# ---------------------------------------------------------------------------
# decompression / encoding
# ---------------------------------------------------------------------------

def decompress(enc: torch.Tensor):
    """(..., 32) uint8 point encoding -> (point, ok_mask).

    Rejects y >= p (non-canonical), off-curve y, and the x=0/sign=1
    encoding — matching ed25519_ref.decode_point / _recover_x."""
    bits = F.bytes_to_bits(enc)
    sign = bits[..., 255]
    y = F.bits_to_limbs(torch.cat([bits[..., :255],
                                   torch.zeros_like(bits[..., :1])], dim=-1))

    # canonicality: y < p  <=>  y + 19 < 2^255
    t = F._carry_full(F._add_at(y, 0, 19), F.NLIMBS)
    canonical = (t[..., 21] >> 3) == 0

    one = F.const(1, (), enc.device)
    yy = F.mul(y, y)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, _c(_D, y)), one)
    v3 = F.mul(F.mul(v, v), v)
    v7 = F.mul(F.mul(v3, v3), v)
    x = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.mul(x, x))
    on_curve_direct = F.is_zero(F.sub(vxx, u))
    on_curve_flipped = F.is_zero(F.add(vxx, u))
    x = torch.where(on_curve_flipped[..., None], F.mul(x, _c(_SQRT_M1, y)), x)
    ok = canonical & (on_curve_direct | on_curve_flipped)

    xf = F.freeze(x)
    x_is_zero = (xf == 0).all(dim=-1)
    ok = ok & ~(x_is_zero & (sign == 1))
    flip = ((xf[..., 0] & 1) != sign)[..., None]
    x = torch.where(flip, F.weak_carry(-x), x)

    t = F.mul(x, y)
    return (x, y, F.const(1, enc.shape[:-1], enc.device), t), ok


def encode(p) -> torch.Tensor:
    """point -> canonical 32-byte encoding (..., 32) uint8."""
    x, y, z, _ = p
    zi = F.inv(z)
    xa = F.freeze(F.mul(x, zi))
    b = F.to_bytes(F.mul(y, zi))
    top = b[..., 31:] + ((xa[..., :1] & 1) << 7).to(torch.uint8)
    return torch.cat([b[..., :31], top], dim=-1)


# ---------------------------------------------------------------------------
# the verify
# ---------------------------------------------------------------------------

def _build_neg_a_table(neg_a):
    """16-entry window table [0..15]*(-A): 4 tensors (..., 16, 22)."""
    rows = [_ident(neg_a[0].shape[:-1], neg_a[0].device), neg_a]
    for _ in range(14):
        rows.append(point_add(rows[-1], neg_a))
    return tuple(torch.stack([r[c] for r in rows], dim=-2) for c in range(4))


def _verify_impl(pubkeys, sigs, msgs):
    """Curve part of the verify (no small-order blacklist)."""
    r_bytes = sigs[..., :32]
    s_bytes = sigs[..., 32:]

    both, both_ok = decompress(torch.stack([pubkeys, r_bytes], dim=0))
    a_pt = tuple(c[0] for c in both)
    a_ok, r_ok = both_ok[0], both_ok[1]
    s_ok = S.is_canonical(s_bytes)

    digest = sha512_96(torch.cat([r_bytes, pubkeys, msgs], dim=-1))
    h_digits = S.to_digits4(S.reduce512(digest))           # (..., 64)
    s_digits = S.to_digits4(F.from_bytes(s_bytes))         # (..., 64)

    ta = _build_neg_a_table(point_neg(a_pt))
    tb = tuple(_c(_B_TABLE[:, c], pubkeys) for c in range(4))

    acc = _ident(pubkeys.shape[:-1], pubkeys.device)
    for i in range(63, -1, -1):   # MSB-first
        for _ in range(4):
            acc = point_double(acc)
        acc = point_add(acc, _select(tb, s_digits[..., i]))
        acc = point_add(acc, _select(ta, h_digits[..., i]))

    match = (encode(acc) == r_bytes).all(dim=-1)
    return match & a_ok & r_ok & s_ok


def small_order(enc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> bool: the encoding is on the small-order
    blacklist (ed25519_ref.SMALL_ORDER_ENCODINGS)."""
    so = torch.as_tensor(_SMALL_ORDER_NP, device=enc.device)
    return (enc[..., None, :] == so).all(dim=-1).any(dim=-1)


def verify_batch(pubkeys: torch.Tensor, sigs: torch.Tensor,
                 msgs: torch.Tensor) -> torch.Tensor:
    """Batched ed25519 verify: (N,32) x (N,64) x (N,32) uint8 -> (N,) bool,
    the spec's verdicts (libsodium semantics incl. the small-order
    blacklist).  Runs on whatever device the inputs are on (on the CPU, on
    one intra-op thread: ``utils.device.cpu_threads``)."""
    with cpu_threads(pubkeys.device):
        ok = _verify_impl(pubkeys, sigs, msgs)
        return ok & ~small_order(pubkeys) & ~small_order(sigs[..., :32])
