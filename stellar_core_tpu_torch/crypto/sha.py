"""SHA-256 and HKDF (ref: src/crypto/SHA.h, src/overlay/PeerAuth.cpp:111-137)."""
from __future__ import annotations

import hashlib
import hmac as _hmac


def sha256(data: bytes) -> bytes:
    """One-shot SHA-256 (ref: src/crypto/SHA.h sha256())."""
    return hashlib.sha256(data).digest()


class SHA256:
    """Streaming SHA-256 (ref: src/crypto/SHA.h class SHA256)."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()


def blake2(data: bytes) -> bytes:
    """One-shot 32-byte BLAKE2b (ref: src/crypto/BLAKE2.h blake2())."""
    return hashlib.blake2b(data, digest_size=32).digest()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()


def hmac_sha256_verify(key: bytes, data: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(hmac_sha256(key, data), mac)


def hkdf_extract(ikm: bytes, salt: bytes = b"") -> bytes:
    """HKDF-Extract with SHA-256 (ref: src/crypto/ByteSliceHasher / PeerAuth)."""
    return hmac_sha256(salt if salt else b"\x00" * 32, ikm)


def hkdf_expand(prk: bytes, info: bytes, length: int = 32) -> bytes:
    """HKDF-Expand with SHA-256 (ref: src/overlay/PeerAuth.cpp:111)."""
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac_sha256(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:length]
