"""Plain ed25519 for the benchmark's reference and traffic.

Frozen copy of ``stellar_core_tpu_torch/crypto/ed25519_ref.py`` at commit
d11364c (RFC 8032 curve arithmetic, libsodium
``crypto_sign_verify_detached`` semantics: S < L, canonical A, the
small-order blacklist on A and R, and [S]B - [h]A encoded equal to R),
without the kernel's ladder.  Pure Python: it imports nothing of the
program, so the benchmark's verdicts never come from the code under test.
"""
from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # curve constant d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# base point
_By = 4 * pow(5, P - 2, P) % P


def _recover_x(y: int, sign: int) -> int | None:
    """Decompress x from y and sign bit; None if not on curve / non-canonical."""
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate root x = u*v^3 * (u*v^7)^((p-5)/8)
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign == 1:
        return None  # non-canonical: -0
    if x & 1 != sign:
        x = P - x
    return x


Bx = _recover_x(_By, 0)
assert Bx is not None
B = (Bx, _By)

# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
IDENT = (0, 1, 1, 0)


def to_extended(p: tuple[int, int]) -> tuple[int, int, int, int]:
    x, y = p
    return (x, y, 1, x * y % P)


def point_add(p, q):
    """Unified extended-coordinate addition (works for doubling too)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e = b - a
    f = dd - c
    g = dd + c
    h = b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    """Dedicated doubling (dbl-2008-hwcd): cheaper than unified add."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = (a + b) % P
    e = (h - (x1 + y1) * (x1 + y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p):
    x, y, z, t = p
    return ((P - x) % P, y, z, (P - t) % P)


def scalar_mult(k: int, p) -> tuple[int, int, int, int]:
    acc = IDENT
    q = p
    while k:
        if k & 1:
            acc = point_add(acc, q)
        q = point_double(q)
        k >>= 1
    return acc


def encode_point(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decode_point(b: bytes) -> tuple[int, int, int, int] | None:
    if len(b) != 32:
        return None
    yy = int.from_bytes(b, "little")
    sign = yy >> 255
    y = yy & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return to_extended((x, y))


def _is_identity(p) -> bool:
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


def _torsion_points() -> list[tuple[int, int]]:
    """The 8 points of the 8-torsion subgroup, from first principles.

    4-torsion: (0, 1), (0, -1), (±sqrt(-1), 0).  Order-8 points double to
    y = 0, and the extended doubling formula gives y(2P) proportional to
    (x^2 - y^2)(x^2 + y^2), so either x^2 = y^2 (curve eq => y^4 = -1/d) or
    x^2 = -y^2 (curve eq => y^2 = (±sqrt(1+d) - 1)/d).  Candidates are
    filtered by the exact 8P = O check."""
    pts = {(0, 1), (0, P - 1), (SQRT_M1, 0), (P - SQRT_M1, 0)}
    cands: list[int] = []
    d_inv = pow(D, P - 2, P)
    r = _sqrt((P - 1) * d_inv % P)  # sqrt(-1/d)
    if r is not None:
        for y2 in (r, P - r):
            y = _sqrt(y2)
            if y is not None:
                cands += [y, P - y]
    s = _sqrt((1 + D) % P)
    if s is not None:
        for pm in (s, P - s):
            y = _sqrt((pm - 1) * d_inv % P)
            if y is not None:
                cands += [y, P - y]
    for y in cands:
        for sign in (0, 1):
            x = _recover_x(y, sign)
            if x is not None:
                pts.add((x, y))
    out = sorted(pt for pt in pts
                 if _is_identity(scalar_mult(8, to_extended(pt))))
    assert len(out) == 8, f"expected 8 torsion points, got {len(out)}"
    return out


def _sqrt(a: int) -> int | None:
    """Square root mod p (p = 5 mod 8), or None."""
    a %= P
    x = pow(a, (P + 3) // 8, P)
    if x * x % P == a:
        return x
    x = x * SQRT_M1 % P
    if x * x % P == a:
        return x
    return None


def small_order_encodings() -> list[bytes]:
    """Canonical encodings of the 8-torsion subgroup, with both sign-bit
    variants of the x=0 points — the byte patterns libsodium's
    ge25519_has_small_order blacklists (restricted to canonical y; the
    non-canonical blacklist rows are subsumed by canonicality rejection)."""
    encs = set()
    for (x, y) in _torsion_points():
        encs.add(int.to_bytes(y | ((x & 1) << 255), 32, "little"))
        if x == 0:
            # the -0 encodings are also blacklisted byte patterns
            encs.add(int.to_bytes(y | (1 << 255), 32, "little"))
    return sorted(encs)


SMALL_ORDER_ENCODINGS = small_order_encodings()


def has_small_order(b: bytes) -> bool:
    return b in SMALL_ORDER_ENCODINGS


def hram(r_bytes: bytes, a_bytes: bytes, message: bytes) -> int:
    """h = SHA-512(R || A || M) mod L."""
    return int.from_bytes(hashlib.sha512(r_bytes + a_bytes + message).digest(), "little") % L


_BASE_POWERS: list | None = None


def _base_powers() -> list:
    """[B*2^i] for i in 0..255 — keygen/sign do many [k]B multiplies; the
    precomputed doubling chain halves their cost (built once, lazily)."""
    global _BASE_POWERS
    if _BASE_POWERS is None:
        q = to_extended(B)
        tbl = []
        for _ in range(256):
            tbl.append(q)
            q = point_double(q)
        _BASE_POWERS = tbl
    return _BASE_POWERS


def scalar_mult_base(k: int) -> tuple[int, int, int, int]:
    """[k]B via the precomputed doubling chain."""
    tbl = _base_powers()
    acc = IDENT
    i = 0
    while k:
        if k & 1:
            acc = point_add(acc, tbl[i])
        k >>= 1
        i += 1
    return acc


def expand_seed(seed: bytes) -> tuple[int, bytes]:
    """RFC 8032 key expansion: clamped scalar + the signing prefix."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_from_seed(seed: bytes) -> bytes:
    """Derive the 32-byte public key A = [a]B from a seed."""
    a, _ = expand_seed(seed)
    return encode_point(scalar_mult_base(a))


def sign(seed: bytes, message: bytes) -> bytes:
    """RFC 8032 detached signature (deterministic, so bit-identical to
    every other RFC 8032 signer)."""
    a, prefix = expand_seed(seed)
    a_bytes = encode_point(scalar_mult_base(a))
    r = int.from_bytes(
        hashlib.sha512(prefix + message).digest(), "little") % L
    r_bytes = encode_point(scalar_mult_base(r))
    k = hram(r_bytes, a_bytes, message)
    s = (r + k * a) % L
    return r_bytes + s.to_bytes(32, "little")


def verify(pubkey: bytes, signature: bytes, message: bytes) -> bool:
    """libsodium crypto_sign_verify_detached semantics (see module doc)."""
    if len(pubkey) != 32 or len(signature) != 64:
        return False
    r_bytes, s_bytes = signature[:32], signature[32:]
    s = int.from_bytes(s_bytes, "little")
    if s >= L:
        return False
    if has_small_order(pubkey) or has_small_order(r_bytes):
        return False
    a = decode_point(pubkey)
    if a is None:
        return False
    h = hram(r_bytes, pubkey, message)
    # R' = [s]B - [h]A, compared bytewise against R (rejects any
    # non-canonical R: the computed encoding is canonical)
    rp = point_add(scalar_mult(s, to_extended(B)), scalar_mult(h, point_neg(a)))
    return encode_point(rp) == r_bytes
