"""The verify kernel's work and bound, for its roofline share.

Frozen copy of ``chip_smoke.py``'s ``decompress_work``, ``zero_digits``,
``verify_work`` and ``bound_ms_verify`` at commit d11364c, with the peaks
read from ``benchmark/peaks.json`` instead of literals.  ``ref`` is
``benchmark.reference.ed25519``.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def load_peaks() -> dict:
    """The published peaks of one H100 that the bound divides by."""
    return json.loads(PEAKS.read_text())


@functools.cache
def decompress_work(ref, a: bytes) -> tuple[int, bool]:
    """Field multiplications of the verify kernel's decompression of A
    (18, and one more for the sqrt(-1) flip; its squarings are always 255),
    and whether A decodes."""
    p, y = ref.P, int.from_bytes(a, "little") & (2**255 - 1)
    u, v = (y * y - 1) % p, (ref.D * y * y + 1) % p
    x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
    flip = (v * x * x + u) % p == 0
    return 18 + flip, ref.decode_point(a) is not None


def zero_digits(k: int) -> int:
    """Digits of 0 among the 64 signed radix-16 digits of k < 2^254 (the
    nibbles of k + 0x88..8 that are 8)."""
    return (k + int("8" * 64, 16)).to_bytes(32, "little").hex().count("8")


def verify_work(ref, a: bytes, sig: bytes, msg: bytes) -> tuple[int, int]:
    """(squarings, multiplications) of the field that the verify kernel
    (csrc/ed25519_verify.cu) does for one row.  A row that the byte checks
    refuse takes none, one whose A is off the curve the decompression
    alone.  Any other takes the decompression, the [1..8](-A) table (65
    M), 64 windows of 4 doublings (16 S + 13 M) with an add of 8 M for
    each nonzero digit of h and one of 6 M for each nonzero digit of s,
    and the encoding (254 S + 13 M)."""
    r, s = sig[:32], int.from_bytes(sig[32:], "little")
    mask = 2**255 - 1
    if (s >= ref.L or int.from_bytes(a, "little") & mask >= ref.P
            or int.from_bytes(r, "little") & mask >= ref.P
            or ref.has_small_order(a) or ref.has_small_order(r)):
        return 0, 0
    mul, decodes = decompress_work(ref, a)
    if not decodes:
        return 255, mul
    h = ref.hram(r, a, msg)
    mul += (65 + 64 * 13 + 8 * (64 - zero_digits(h))
            + 6 * (64 - zero_digits(s)) + 13)
    return 255 + 64 * 16 + 254, mul


def bound_ms_verify(ref, pk, sg, mg, peaks=None) -> tuple[float, str, int]:
    """Least time the H100 could take to verify these rows: the larger of
    the bytes (each input read once, one byte out a row) over 3.35 TB/s
    and the 32x32->64-bit products over 16.7 T/s, the int32 multiply-add
    rate (half the 67 TFLOP/s fp32 FMA rate: 64 vs 128 lanes per SM per
    clock).  Products: 36 a squaring and 64 a multiplication, for the work
    that these rows need (``verify_work``); SHA-512, carries and the
    prologue are not counted, so this stays a lower bound.  Returns the
    ms, what bounds it, and the products."""
    peaks = peaks or load_peaks()
    products = 0
    for a, s, m in zip(pk, sg, mg):
        sq, mul = verify_work(ref, a.tobytes(), s.tobytes(), m.tobytes())
        products += 36 * sq + 64 * mul
    ops_ms = products / peaks["int32_mul_add_per_s"] * 1e3
    bytes_ms = len(pk) * (32 + 64 + 32 + 1) / peaks["hbm_bytes_per_s"] * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", products)
