"""BucketIndex: per-bucket point-read indexes for the BucketListDB read
path (ref src/bucket/BucketIndexImpl.cpp + src/bucket/readme.md:30-101 —
every bucket carries a bloom filter so a lookup touches ~1 bucket's data
instead of scanning all 22 levels, plus an exact key index so the one
touched bucket answers in O(log n) with a single entry-sized read).

Three index shapes, one protocol (``may_contain`` / ``find``):

- ``MemBucketIndex`` — small in-memory buckets get an exact dict
  (key -> position), which subsumes a bloom filter: a dict miss is a
  definitive "not here".  Large in-memory buckets (deep levels kept in
  memory by small configs) get a blocked bloom + the bucket's cached
  sorted-keys bisect.
- ``DiskBucketIndex`` — disk-tier buckets get the blocked bloom plus the
  sorted key->offset table that already lives in the ``.idx`` sidecar
  (PR 1's native-merge entry tables): a hit binary-searches the
  memmapped key table and reads exactly one entry's bytes at its offset.
  The bloom is persisted as an appended sidecar section (``BKBLM01``) so
  a restart re-opens it without rescanning the stream.

The bloom filter is a blocked bloom: one 64-bit block per
``h1 % n_blocks``, four bits per key from 6-bit slices of ``h2``, where
``h1/h2`` are zlib-compatible CRC-32 values (h2 seeded with
0x9E3779B9).  The native kernel (``native/bucket_merge.cpp`` bloom_fill /
bloom_check) and this module produce bit-identical filters, so either
tier can build what the other queries.  At ~BITS_PER_KEY bits/key the
measured false-positive rate is ~1-2% (surfaced per BucketList in
``stats["bloom_false_positives"]``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple
from zlib import crc32

import numpy as np

# bloom sizing: one uint64 block per BLOCK_KEYS keys ~= 10.7 bits/key;
# with K=4 probe bits the measured FPR is ~1-2%
BLOCK_KEYS = 6
BLOOM_SEED2 = 0x9E3779B9
# in-memory buckets up to this size get the exact dict index; bigger ones
# get bloom + bisect (a dict over millions of keys costs ~100B/key)
DICT_MAX = 1 << 16

_BLM_MAGIC = b"BKBLM01\n"


def _probe_mask(h2: int) -> int:
    m = 0
    for shift in (0, 6, 12, 18):
        m |= 1 << ((h2 >> shift) & 63)
    return m


class BloomFilter:
    """Blocked bloom filter over key bytes (layout shared with the native
    kernel — see module docstring)."""

    __slots__ = ("words", "n_blocks")

    def __init__(self, words: np.ndarray):
        self.words = words
        self.n_blocks = len(words)

    @classmethod
    def build(cls, keys, n_hint: Optional[int] = None) -> "BloomFilter":
        """Build from an iterable of key bytes (pure Python tier)."""
        keys = keys if isinstance(keys, (list, tuple)) else list(keys)
        n = n_hint if n_hint is not None else len(keys)
        n_blocks = max(1, (n + BLOCK_KEYS - 1) // BLOCK_KEYS)
        words = [0] * n_blocks
        for kb in keys:
            h1 = crc32(kb)
            words[h1 % n_blocks] |= _probe_mask(crc32(kb, BLOOM_SEED2))
        return cls(np.array(words, np.uint64))

    @classmethod
    def build_from_table(cls, keys_blob, koff, klen) -> "BloomFilter":
        """Build from a flat key table (sidecar shape); uses the native
        kernel when available, bit-identical Python loop otherwise."""
        n = len(koff)
        n_blocks = max(1, (n + BLOCK_KEYS - 1) // BLOCK_KEYS)
        out = _native_bloom_fill(keys_blob, koff, klen, n_blocks)
        if out is not None:
            return cls(out)
        words = [0] * n_blocks
        for i in range(n):
            kb = bytes(keys_blob[koff[i]:koff[i] + klen[i]])
            words[crc32(kb) % n_blocks] |= _probe_mask(
                crc32(kb, BLOOM_SEED2))
        return cls(np.array(words, np.uint64))

    def may_contain(self, kb: bytes) -> bool:
        w = int(self.words[crc32(kb) % self.n_blocks])
        m = _probe_mask(crc32(kb, BLOOM_SEED2))
        return (w & m) == m

    def check_batch(self, kbs: List[bytes]) -> List[bool]:
        """Batched membership (the prefetch feed): one native bloom_check
        call for the whole probe set; Python loop fallback."""
        out = _native_bloom_check(self, kbs)
        if out is not None:
            return out
        return [self.may_contain(kb) for kb in kbs]

    # -- persistence (sidecar section) -------------------------------------

    def to_bytes(self) -> bytes:
        return (_BLM_MAGIC
                + np.array([self.n_blocks], np.int64).tobytes()
                + np.ascontiguousarray(self.words, np.uint64).tobytes())

    @classmethod
    def from_bytes(cls, data: bytes) -> Optional["BloomFilter"]:
        if not data.startswith(_BLM_MAGIC):
            return None
        try:
            n_blocks = int(np.frombuffer(data, np.int64, count=1,
                                         offset=len(_BLM_MAGIC))[0])
            words = np.frombuffer(data, np.uint64, count=n_blocks,
                                  offset=len(_BLM_MAGIC) + 8)
        except ValueError:
            return None
        if len(words) != n_blocks:
            return None
        return cls(words)

    @property
    def nbytes(self) -> int:
        return 8 * self.n_blocks


def _native_bloom_fill(keys_blob, koff, klen,
                       n_blocks: int) -> Optional[np.ndarray]:
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "bloom_fill"):
        return None
    words = np.zeros(n_blocks, np.uint64)
    lib.bloom_fill(
        _pblob(keys_blob),
        np.ascontiguousarray(koff, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)),
        np.ascontiguousarray(klen, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)),
        len(koff),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_blocks)
    return words


def _pblob(blob):
    """bytes or uint8-array (incl. memmap) -> ctypes char pointer."""
    import ctypes

    if isinstance(blob, bytes):
        return blob
    return blob.ctypes.data_as(ctypes.c_char_p)


def _probe_table(kbs: List[bytes]):
    p_len = np.array([len(kb) for kb in kbs], np.int32)
    p_off = np.zeros(len(kbs), np.int64)
    if len(kbs) > 1:
        np.cumsum(p_len[:-1], out=p_off[1:])
    return b"".join(kbs), p_off, p_len


def _native_bloom_check(bloom: "BloomFilter",
                        kbs: List[bytes]) -> Optional[List[bool]]:
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "bloom_check") or not kbs:
        return None
    probes, p_off, p_len = _probe_table(kbs)
    hits = np.zeros(len(kbs), np.int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.bloom_check(
        np.ascontiguousarray(bloom.words, np.uint64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint64)),
        bloom.n_blocks,
        probes, p_off.ctypes.data_as(p64), p_len.ctypes.data_as(p32),
        len(kbs), hits.ctypes.data_as(p32))
    return [bool(h) for h in hits]


class MemBucketIndex:
    """Index for an in-memory Bucket: exact dict when small, blocked
    bloom + the bucket's cached keys bisect when large."""

    __slots__ = ("_pos", "bloom")

    def __init__(self, keys: Tuple[bytes, ...]):
        if len(keys) <= DICT_MAX:
            self._pos: Optional[Dict[bytes, int]] = {
                kb: i for i, kb in enumerate(keys)}
            self.bloom: Optional[BloomFilter] = None
        else:
            self._pos = None
            # large bucket: flatten once and let the native kernel fill
            # the filter — the pure-Python loop holds the GIL >100ms at
            # this size, which measurably stalls concurrent closes when
            # a merge worker builds the index (BUCKET_SCALE regression)
            n = len(keys)
            klen = np.fromiter(map(len, keys), np.int32, n)
            koff = np.zeros(n, np.int64)
            if n > 1:
                np.cumsum(klen[:-1], out=koff[1:])
            self.bloom = BloomFilter.build_from_table(
                b"".join(keys), koff, klen)

    def may_contain(self, kb: bytes) -> bool:
        if self._pos is not None:
            return kb in self._pos
        return self.bloom.may_contain(kb)

    def check_batch(self, kbs: List[bytes]) -> List[bool]:
        if self._pos is not None:
            return [kb in self._pos for kb in kbs]
        return self.bloom.check_batch(kbs)

    def find_batch(self, bucket, kbs: List[bytes]) -> List[object]:
        return [self.find(bucket, kb) for kb in kbs]

    def find(self, bucket, kb: bytes):
        """The data probe: the BucketEntry for kb, or None (a None after
        a positive may_contain is a bloom false positive)."""
        if self._pos is not None:
            i = self._pos.get(kb)
            return None if i is None else bucket.entries[i][1]
        import bisect

        keys = bucket.keys
        i = bisect.bisect_left(keys, kb)
        if i < len(keys) and keys[i] == kb:
            return bucket.entries[i][1]
        return None

    @property
    def nbytes(self) -> int:
        if self._pos is not None:
            # dict overhead ~100B/key resident on top of shared key bytes
            return 104 * len(self._pos)
        return self.bloom.nbytes


class DiskBucketIndex:
    """Index for a DiskBucket: bloom + the sidecar's sorted key/offset
    table.  Arrays are memmapped from the sidecar whenever possible so a
    1M-entry bucket's index costs ~bloom bytes of resident memory; a
    lookup touches O(log n) key-table pages plus one entry read."""

    __slots__ = ("count", "eoff", "elen", "koff", "klen", "keys", "bloom",
                 "resident_bytes")

    def __init__(self, eoff, elen, koff, klen, keys, bloom: BloomFilter,
                 resident_bytes: Optional[int] = None):
        self.count = len(eoff)
        self.eoff = eoff
        self.elen = elen
        self.koff = koff
        self.klen = klen
        self.keys = keys
        self.bloom = bloom
        if resident_bytes is None:
            resident_bytes = (bloom.nbytes
                              + sum(a.nbytes for a in (eoff, elen, koff,
                                                       klen))
                              + (len(keys) if isinstance(keys, bytes)
                                 else 0))
        self.resident_bytes = resident_bytes

    def may_contain(self, kb: bytes) -> bool:
        return self.bloom.may_contain(kb)

    def check_batch(self, kbs: List[bytes]) -> List[bool]:
        return self.bloom.check_batch(kbs)

    def _key_at(self, i: int) -> bytes:
        o = int(self.koff[i])
        return bytes(self.keys[o:o + int(self.klen[i])])

    def position(self, kb: bytes) -> int:
        """lower_bound over the key table (first index with key >= kb)."""
        lo, hi = 0, self.count
        while lo < hi:
            mid = (lo + hi) // 2
            if self._key_at(mid) < kb:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def entry_span(self, kb: bytes) -> Optional[Tuple[int, int]]:
        """(file offset, length) of kb's entry, or None."""
        i = self.position(kb)
        if i < self.count and self._key_at(i) == kb:
            return int(self.eoff[i]), int(self.elen[i])
        return None

    def find(self, bucket, kb: bytes):
        span = self.entry_span(kb)
        if span is None:
            return None
        return bucket.read_entry_at(*span)

    def find_batch(self, bucket, kbs: List[bytes]) -> List[object]:
        """Batched exact lookup: one native lower_bound call over the
        whole probe set, then an entry read per verified hit (the
        get_entries/prefetch hot path)."""
        out: List[object] = []
        for kb, pos in zip(kbs, self.positions_batch(kbs)):
            i = int(pos)
            if i < self.count and self._key_at(i) == kb:
                out.append(bucket.read_entry_at(int(self.eoff[i]),
                                                int(self.elen[i])))
            else:
                out.append(None)
        return out

    def positions_batch(self, kbs: List[bytes]) -> np.ndarray:
        """Batched lower_bound over the key table — one native call for
        the whole probe set (prefetch path); Python loop fallback."""
        out = _native_lower_bound(self, kbs)
        if out is not None:
            return out
        return np.array([self.position(kb) for kb in kbs], np.int64)

    @property
    def nbytes(self) -> int:
        return self.resident_bytes


def _native_lower_bound(idx: DiskBucketIndex,
                        kbs: List[bytes]) -> Optional[np.ndarray]:
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "bucket_lower_bound"):
        return None
    probes, p_off, p_len = _probe_table(kbs)
    out = np.zeros(len(kbs), np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.bucket_lower_bound(
        _pblob(idx.keys),
        np.ascontiguousarray(idx.koff, np.int64).ctypes.data_as(p64),
        np.ascontiguousarray(idx.klen, np.int32).ctypes.data_as(p32),
        idx.count,
        probes, p_off.ctypes.data_as(p64), p_len.ctypes.data_as(p32),
        len(kbs), out.ctypes.data_as(p64))
    return out


# -- sidecar bloom section ---------------------------------------------------

def sidecar_bloom_offset(path: str) -> Optional[int]:
    """Byte offset of the bloom section inside a sidecar file (i.e. the
    end of the PR-1 entry table), or None if the header is unreadable."""
    from .disk_bucket import _IDX_MAGIC

    try:
        with open(path, "rb") as f:
            head = f.read(len(_IDX_MAGIC) + 16)
    except OSError:
        return None
    if not head.startswith(_IDX_MAGIC):
        return None
    n, keys_bytes = np.frombuffer(head, np.int64, count=2,
                                  offset=len(_IDX_MAGIC))
    return len(_IDX_MAGIC) + 16 + int(n) * 28 + int(keys_bytes)


def read_sidecar_bloom(path: str) -> Optional[BloomFilter]:
    off = sidecar_bloom_offset(path)
    if off is None:
        return None
    try:
        with open(path, "rb") as f:
            f.seek(off)
            data = f.read()
    except OSError:
        return None
    return BloomFilter.from_bytes(data)


def load_disk_index(sidecar_path: str,
                    expected_count: int) -> Optional[DiskBucketIndex]:
    """Open a sidecar's entry table as memmapped arrays + its persisted
    bloom.  None when the sidecar is missing/stale or carries no bloom
    section (callers rebuild and rewrite it)."""
    from .disk_bucket import _IDX_MAGIC

    try:
        size = os.path.getsize(sidecar_path)
        with open(sidecar_path, "rb") as f:
            head = f.read(len(_IDX_MAGIC) + 16)
    except OSError:
        return None
    if not head.startswith(_IDX_MAGIC):
        return None
    n, keys_bytes = (int(x) for x in np.frombuffer(
        head, np.int64, count=2, offset=len(_IDX_MAGIC)))
    if n != expected_count:
        return None
    off = len(_IDX_MAGIC) + 16
    need = off + n * 28 + keys_bytes
    if size < need:
        return None
    bloom = read_sidecar_bloom(sidecar_path)
    if bloom is None:
        return None
    try:
        eoff = np.memmap(sidecar_path, np.int64, "r", off, (n,))
        elen = np.memmap(sidecar_path, np.int32, "r", off + 8 * n, (n,))
        koff = np.memmap(sidecar_path, np.int64, "r", off + 16 * n, (n,))
        klen = np.memmap(sidecar_path, np.int32, "r", off + 24 * n, (n,))
        keys = np.memmap(sidecar_path, np.uint8, "r", off + 28 * n,
                         (keys_bytes,))
    except (OSError, ValueError):
        return None
    return DiskBucketIndex(eoff, elen, koff, klen, keys, bloom,
                           resident_bytes=bloom.nbytes)
