"""StrKey: base32-check human-readable key encodings (ref: src/crypto/StrKey.h:28-35).

G... = ed25519 public key, S... = ed25519 seed, plus the other version bytes
the reference defines (pre-auth-tx, hash-x, muxed, signed-payload).
CRC16-XMODEM checksum, RFC 4648 base32 without padding stripping ambiguity.
"""
from __future__ import annotations

import base64

# version bytes (ref: src/crypto/StrKey.h enum StrKeyVersionByte)
VER_PUBKEY_ED25519 = 6 << 3  # 'G'
VER_SEED_ED25519 = 18 << 3  # 'S'
VER_PRE_AUTH_TX = 19 << 3  # 'T'
VER_HASH_X = 23 << 3  # 'X'
VER_MUXED_ACCOUNT = 12 << 3  # 'M'
VER_SIGNED_PAYLOAD = 15 << 3  # 'P'


def _crc16_xmodem(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def encode_check(version_byte: int, payload: bytes) -> str:
    body = bytes([version_byte]) + payload
    crc = _crc16_xmodem(body)
    body += bytes([crc & 0xFF, crc >> 8])  # little-endian checksum
    return base64.b32encode(body).decode().rstrip("=")


def decode_check(expected_version: int, encoded: str) -> bytes:
    pad = (-len(encoded)) % 8
    try:
        raw = base64.b32decode(encoded + "=" * pad)
    except Exception as e:  # malformed base32
        raise ValueError(f"invalid strkey: {e}") from None
    if len(raw) < 3:
        raise ValueError("strkey too short")
    body, check = raw[:-2], raw[-2:]
    crc = _crc16_xmodem(body)
    if check != bytes([crc & 0xFF, crc >> 8]):
        raise ValueError("strkey checksum mismatch")
    if body[0] != expected_version:
        raise ValueError("strkey version byte mismatch")
    return body[1:]


def encode_ed25519_public_key(raw: bytes) -> str:
    return encode_check(VER_PUBKEY_ED25519, raw)


def decode_ed25519_public_key(s: str) -> bytes:
    out = decode_check(VER_PUBKEY_ED25519, s)
    if len(out) != 32:
        raise ValueError("bad public key length")
    return out


def encode_ed25519_seed(raw: bytes) -> str:
    return encode_check(VER_SEED_ED25519, raw)


def decode_ed25519_seed(s: str) -> bytes:
    out = decode_check(VER_SEED_ED25519, s)
    if len(out) != 32:
        raise ValueError("bad seed length")
    return out
