"""SipHash-2-4 keyed short hashing (ref: src/crypto/ShortHash.h).

Used for non-cryptographic hash maps keyed per-process to resist
hash-flooding, mirroring the reference's shortHash::computeHash.
"""
from __future__ import annotations

import os
import struct

_key = os.urandom(16)


def shorthash_init(key: bytes | None = None) -> None:
    """(Re)initialize the process-wide siphash key (ref shortHash::initialize)."""
    global _key
    _key = key if key is not None else os.urandom(16)
    if len(_key) != 16:
        raise ValueError("siphash key must be 16 bytes")


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & 0xFFFFFFFFFFFFFFFF


def _sipround(v0: int, v1: int, v2: int, v3: int):
    v0 = (v0 + v1) & 0xFFFFFFFFFFFFFFFF
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & 0xFFFFFFFFFFFFFFFF
    v3 = _rotl(v3, 16) ^ v2
    v0 = (v0 + v3) & 0xFFFFFFFFFFFFFFFF
    v3 = _rotl(v3, 21) ^ v0
    v2 = (v2 + v1) & 0xFFFFFFFFFFFFFFFF
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 producing a 64-bit value."""
    k0, k1 = struct.unpack("<QQ", key)
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573
    b = len(data) & 0xFF
    i = 0
    while i + 8 <= len(data):
        (m,) = struct.unpack_from("<Q", data, i)
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
        i += 8
    tail = data[i:]
    m = b << 56
    for j, byte in enumerate(tail):
        m |= byte << (8 * j)
    v3 ^= m
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= m
    v2 ^= 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def shorthash(data: bytes) -> int:
    """Process-keyed 64-bit short hash (ref shortHash::computeHash)."""
    return siphash24(_key, data)
