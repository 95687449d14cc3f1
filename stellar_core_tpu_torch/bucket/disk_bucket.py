"""Disk-backed buckets with a sparse page index (VERDICT r4 task 5; ref
src/bucket/BucketOutputIterator.cpp streaming writes + BucketIndexImpl's
RangeIndex: key-range -> file-offset pages, src/bucket/readme.md:30-101).

A DiskBucket is the canonical storage tier for DEEP levels of the
BucketList: an immutable sorted XDR stream of BucketEntry on disk, with

- the sha256 bucket hash computed incrementally while writing (identical
  to the in-memory tier's hash of the same entries);
- a sparse in-memory index holding every PAGE-th key and its file
  offset (~len/PAGE keys resident, the rest of the bucket stays on
  disk), giving get() a bisect + one-page scan like the reference's
  RangeIndex lookup;
- streaming k=2 merges (merge_stream) that read both inputs
  entry-by-entry and write the output incrementally, so a GB-scale
  merge needs O(PAGE) memory, the property the reference's whole bucket
  design exists for.

Entry iteration order and collision semantics are shared with the
in-memory tier (bucket_list._merge_entry), so a Disk/Mem merge of the
same inputs is bitwise identical whichever tier runs it.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Tuple

import hashlib
from ..xdr import types as T
from ..xdr.runtime import Reader

BET = T.BucketEntryType
PAGE = 64  # entries per index page
_READ_CHUNK = 1 << 20

# sidecar entry-table files (<bucket>.xdr.idx): per-entry offsets, types
# and key bytes persisted next to the stream so deep-level merges can run
# entirely inside the native GIL-free kernel without re-parsing XDR
_IDX_MAGIC = b"BKIDX01\n"


def entry_key_bytes(e) -> bytes:
    from ..ledger.ledger_txn import entry_to_key, key_bytes

    if e.type == BET.DEADENTRY:
        return T.LedgerKey.encode(e.value)
    return key_bytes(entry_to_key(e.value))


class DiskBucket:
    """Immutable sorted run of BucketEntry backed by a file."""

    __slots__ = ("path", "count", "_hash", "page_keys", "page_offs",
                 "size_bytes", "_index", "_fd")

    def __init__(self, path: str, count: int, hash_: bytes,
                 page_keys: List[bytes], page_offs: List[int],
                 size_bytes: int):
        self.path = path
        self.count = count
        self._hash = hash_
        self.page_keys = page_keys
        self.page_offs = page_offs
        self.size_bytes = size_bytes
        self._index = None
        self._fd: Optional[int] = None

    def __del__(self):
        if getattr(self, "_fd", None) is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass

    # -- interface shared with bucket_list.Bucket -------------------------

    def is_empty(self) -> bool:
        return self.count == 0

    def __len__(self) -> int:
        return self.count

    def hash(self) -> bytes:
        return self._hash

    @property
    def entries(self) -> Tuple[Tuple[bytes, object], ...]:
        """Materialized (key, entry) tuple — only for small buckets /
        tests; large buckets should use iter_entries()."""
        return tuple(self.iter_entries())

    def iter_entries(self) -> Iterator[Tuple[bytes, object]]:
        if self.count == 0:
            return
        with open(self.path, "rb") as f:
            buf = b""
            pos = 0
            while True:
                chunk = f.read(_READ_CHUNK)
                if not chunk:
                    break
                buf = buf[pos:] + chunk
                pos = 0
                r = Reader(buf)
                while True:
                    mark = r.pos
                    try:
                        e = T.BucketEntry.unpack(r)
                    except Exception:
                        pos = mark
                        break
                    yield entry_key_bytes(e), e
                    pos = r.pos
            if pos < len(buf):
                r = Reader(buf[pos:])
                while not r.done():
                    e = T.BucketEntry.unpack(r)
                    yield entry_key_bytes(e), e

    def ensure_index(self):
        """The bucket's BucketIndex (bucket/index.py): bloom + memmapped
        key/offset table from the sidecar.  Loaded from the persisted
        bloom section when present; otherwise built from the entry table
        and persisted (legacy PR-1 sidecars upgrade in place)."""
        if self._index is not None or self.count == 0:
            return self._index
        from .index import (BloomFilter, DiskBucketIndex, load_disk_index)

        idx = load_disk_index(_sidecar_path(self.path), self.count)
        if idx is None:
            t = _read_sidecar(self.path, expected_size=self.size_bytes)
            if t is None:
                t = _scan_tables(self.path)
            eoff, elen, types, koff, klen, keys = t
            bloom = BloomFilter.build_from_table(keys, koff, klen)
            _write_sidecar(self.path, eoff, elen, types, koff, klen,
                           keys if isinstance(keys, bytes)
                           else bytes(keys), bloom=bloom)
            idx = load_disk_index(_sidecar_path(self.path), self.count)
            if idx is None:  # unwritable store: keep the in-RAM table
                idx = DiskBucketIndex(eoff, elen, koff, klen, keys, bloom)
        self._index = idx
        return idx

    def read_entry_at(self, offset: int, length: int):
        """Decode the single BucketEntry at a known file span — the
        index-hit read.  pread on a cached fd: one syscall, no seek
        state, safe under concurrent readers (the point-read hot path
        must not pay an open/close pair per lookup)."""
        fd = self._fd
        if fd is None:
            fd = os.open(self.path, os.O_RDONLY)
            # two racing openers: the check-and-store below has no GIL
            # release point, so exactly one fd wins; the loser closes
            # its own (no leak)
            if self._fd is None:
                self._fd = fd
            else:
                os.close(fd)
                fd = self._fd
        data = os.pread(fd, length, offset)
        return T.BucketEntry.unpack(Reader(data))

    def get(self, kb: bytes):
        """Key lookup: exact index when built (binary-search the sidecar
        key table, read one entry), else bisect the sparse page index and
        scan one page (ref BucketIndex::scan)."""
        import bisect

        if self.count == 0:
            return None
        if self._index is not None:
            span = self._index.entry_span(kb)
            if span is None:
                return None
            return self.read_entry_at(*span)
        i = bisect.bisect_right(self.page_keys, kb) - 1
        if i < 0:
            return None
        with open(self.path, "rb") as f:
            f.seek(self.page_offs[i])
            end = (self.page_offs[i + 1]
                   if i + 1 < len(self.page_offs) else self.size_bytes)
            r = Reader(f.read(end - self.page_offs[i]))
            while not r.done():
                e = T.BucketEntry.unpack(r)
                k = entry_key_bytes(e)
                if k == kb:
                    return e
                if k > kb:
                    return None
        return None

    def serialize(self) -> bytes:
        with open(self.path, "rb") as f:
            return f.read()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_entries(cls, directory: str,
                     entries: Iterable[Tuple[bytes, object]],
                     protect=None) -> "DiskBucket":
        """Stream (key, entry) pairs (already sorted, collisions resolved)
        to a content-addressed file <dir>/bucket-<hash>.xdr, recording the
        per-entry sidecar table alongside so later merges over this bucket
        can run in the native kernel without re-parsing the stream.
        ``protect(hash_hex)``, when given, is invoked BEFORE the output
        becomes visible under its content-addressed name — background
        workers use it to register the file against store GC."""
        from array import array

        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".tmp-{os.getpid()}-{id(entries)}")
        h = hashlib.sha256()
        page_keys: List[bytes] = []
        page_offs: List[int] = []
        eoff = array("q")
        elen = array("i")
        types = array("i")
        klen = array("i")
        key_parts: List[bytes] = []
        count = 0
        off = 0
        with open(tmp, "wb") as f:
            for kb, e in entries:
                data = T.BucketEntry.encode(e)
                if count % PAGE == 0:
                    page_keys.append(kb)
                    page_offs.append(off)
                f.write(data)
                h.update(data)
                eoff.append(off)
                elen.append(len(data))
                types.append(e.type)
                klen.append(len(kb))
                key_parts.append(kb)
                off += len(data)
                count += 1
        if count == 0:
            os.unlink(tmp)
            return cls("", 0, b"\x00" * 32, [], [], 0)
        digest = h.digest()
        path = os.path.join(directory, f"bucket-{digest.hex()}.xdr")
        if protect is not None:
            protect(digest.hex())
        os.replace(tmp, path)
        import numpy as np

        klen_np = np.frombuffer(klen, dtype=np.int32)
        koff = np.zeros(count, np.int64)
        np.cumsum(klen_np[:-1], out=koff[1:])
        _write_sidecar(path, np.frombuffer(eoff, dtype=np.int64),
                       np.frombuffer(elen, dtype=np.int32),
                       np.frombuffer(types, dtype=np.int32),
                       koff, klen_np, b"".join(key_parts))
        out = cls(path, count, digest, page_keys, page_offs, off)
        from .index import load_disk_index

        out._index = load_disk_index(_sidecar_path(path), count)
        return out

    @classmethod
    def open(cls, path: str,
             expected_hash: Optional[bytes] = None) -> "DiskBucket":
        """Index an existing bucket file (restore/catchup), verifying the
        streamed hash when given.  A valid sidecar table skips the XDR
        re-parse (the hash is still recomputed from the raw bytes); a
        missing/stale sidecar triggers a full scan that rebuilds it."""
        h = hashlib.sha256()
        size = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_READ_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
                size += len(chunk)
        digest = h.digest() if size else b"\x00" * 32
        if expected_hash is not None and size and digest != expected_hash:
            raise RuntimeError(f"bucket hash mismatch for {path}")
        if size == 0:
            return cls("", 0, b"\x00" * 32, [], [], 0)
        t = _read_sidecar(path, expected_size=size)
        if t is None:
            t = _scan_tables(path)
            _write_sidecar(path, *t)
        eoff, elen, types, koff, klen, keys = t
        count = len(eoff)
        page_keys = [bytes(keys[koff[i]:koff[i] + klen[i]])
                     for i in range(0, count, PAGE)]
        page_offs = [int(o) for o in eoff[::PAGE]]
        return cls(path, count, digest, page_keys, page_offs, size)

    def merge_table(self):
        """(stream, eoff, elen, keys, koff, klen, types) for the native
        merge kernel; None when unavailable.  The stream is a read-only
        memmap so GB-scale merges keep bounded resident memory."""
        import numpy as np

        if self.count == 0:
            return _empty_table()
        t = _read_sidecar(self.path, expected_size=self.size_bytes)
        if t is None:
            try:
                t = _scan_tables(self.path)
            except (OSError, RuntimeError):
                return None  # unreadable/truncated file: Python-tier merge
            _write_sidecar(self.path, *t)
        eoff, elen, types, koff, klen, keys = t
        if len(eoff) != self.count:
            return None  # stale sidecar: fall back to the Python tier
        stream = np.memmap(self.path, dtype=np.uint8, mode="r")
        return (stream, eoff, elen, keys, koff, klen, types)


def _sidecar_path(path: str) -> str:
    return path + ".idx"


def _write_sidecar(path: str, eoff, elen, types, koff, klen,
                   keys: bytes, bloom=None) -> None:
    """Persist the per-entry table next to the bucket stream (atomic).
    ``bloom`` (a bucket.index.BloomFilter) is appended as a trailing
    section — absent for pre-index writers, ignored by pre-index readers
    (they stop at the keys blob), so both directions stay compatible."""
    import numpy as np

    if bloom is None:
        from .index import BloomFilter

        bloom = BloomFilter.build_from_table(keys, koff, klen)
    sp = _sidecar_path(path)
    tmp = f"{sp}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(_IDX_MAGIC)
            np.array([len(eoff), len(keys)], np.int64).tofile(f)
            np.ascontiguousarray(eoff, np.int64).tofile(f)
            np.ascontiguousarray(elen, np.int32).tofile(f)
            np.ascontiguousarray(types, np.int32).tofile(f)
            np.ascontiguousarray(koff, np.int64).tofile(f)
            np.ascontiguousarray(klen, np.int32).tofile(f)
            f.write(keys)
            f.write(bloom.to_bytes())
        os.replace(tmp, sp)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _read_sidecar(path: str, expected_size: Optional[int] = None):
    """Load the sidecar table; None when missing or inconsistent with the
    stream (e.g. written by an older version, torn, or the stream file
    was replaced)."""
    import numpy as np

    try:
        with open(_sidecar_path(path), "rb") as f:
            data = f.read()
    except OSError:
        return None
    if not data.startswith(_IDX_MAGIC):
        return None
    try:
        head = np.frombuffer(data, np.int64, count=2,
                             offset=len(_IDX_MAGIC))
        n, keys_bytes = int(head[0]), int(head[1])
        off = len(_IDX_MAGIC) + 16
        eoff = np.frombuffer(data, np.int64, count=n, offset=off)
        off += 8 * n
        elen = np.frombuffer(data, np.int32, count=n, offset=off)
        off += 4 * n
        types = np.frombuffer(data, np.int32, count=n, offset=off)
        off += 4 * n
        koff = np.frombuffer(data, np.int64, count=n, offset=off)
        off += 8 * n
        klen = np.frombuffer(data, np.int32, count=n, offset=off)
        off += 4 * n
        keys = data[off:off + keys_bytes]
        if len(keys) != keys_bytes:
            return None
    except (ValueError, IndexError):
        return None
    if n and expected_size is not None and \
            int(eoff[-1]) + int(elen[-1]) != expected_size:
        return None  # sidecar does not describe this stream
    return eoff, elen, types, koff, klen, keys


def _scan_tables(path: str):
    """Parse a bucket stream into the full per-entry table (the slow
    Python path — only for legacy files with no sidecar)."""
    import numpy as np
    from array import array

    eoff = array("q")
    elen = array("i")
    types = array("i")
    klen = array("i")
    key_parts: List[bytes] = []
    file_off = 0
    with open(path, "rb") as f:
        buf = b""
        pos = 0
        while True:
            chunk = f.read(_READ_CHUNK)
            file_off += pos
            buf = buf[pos:] + chunk
            pos = 0
            r = Reader(buf)
            while True:
                mark = r.pos
                try:
                    e = T.BucketEntry.unpack(r)
                except Exception:
                    pos = mark
                    break
                kb = entry_key_bytes(e)
                eoff.append(file_off + mark)
                elen.append(r.pos - mark)
                types.append(e.type)
                klen.append(len(kb))
                key_parts.append(kb)
                pos = r.pos
            if not chunk:
                if pos < len(buf):
                    raise RuntimeError(
                        f"trailing bytes in bucket file {path}")
                break
    n = len(eoff)
    klen_np = np.frombuffer(klen, dtype=np.int32) if n else \
        np.zeros(0, np.int32)
    koff = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(klen_np[:-1], out=koff[1:])
    eoff_np = np.frombuffer(eoff, dtype=np.int64) if n else \
        np.zeros(0, np.int64)
    elen_np = np.frombuffer(elen, dtype=np.int32) if n else \
        np.zeros(0, np.int32)
    types_np = np.frombuffer(types, dtype=np.int32) if n else \
        np.zeros(0, np.int32)
    return eoff_np, elen_np, types_np, koff, klen_np, b"".join(key_parts)


def _empty_table():
    import numpy as np

    z64 = np.zeros(0, np.int64)
    z32 = np.zeros(0, np.int32)
    return (np.zeros(0, np.uint8), z64, z32, b"", z64, z32, z32)


def merge_disk_native(directory: str, newer, older,
                      protect=None) -> Optional["DiskBucket"]:
    """Run a disk-tier merge entirely inside the native kernel: key
    compares, collision rules, entry copy, output stream write and the
    bucket sha256 all happen in one GIL-free C call, so a background
    merge truly overlaps the interpreter.  Returns None when the native
    tier or the entry tables are unavailable (callers fall back to the
    Python streaming merge)."""
    import ctypes

    import numpy as np

    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "bucket_merge_stream"):
        return None
    tn = _table_of(newer)
    to = _table_of(older)
    if tn is None or to is None:
        return None
    (ns, ne, nl, nk, nko, nkl, nt) = tn
    (os_, oe, ol, ok_, oko, okl, ot) = to
    n_new, n_old = len(ne), len(oe)
    cap = n_new + n_old
    out_eoff = np.zeros(cap, np.int64)
    out_elen = np.zeros(cap, np.int32)
    out_types = np.zeros(cap, np.int32)
    out_keys = np.zeros(len(nk) + len(ok_), np.uint8)
    out_koff = np.zeros(cap, np.int64)
    out_klen = np.zeros(cap, np.int32)
    out_hash = np.zeros(32, np.uint8)
    out_bytes = np.zeros(1, np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def pu8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def pstream(s):
        if isinstance(s, bytes):
            return s
        return s.ctypes.data_as(ctypes.c_char_p)

    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory,
                       # id() only uniquifies the tmp filename; output
                       # bytes and hash are key-ordered, the name never
                       # reaches them
                       # detlint: allow(det-interproc-taint)
                       f".merge-{os.getpid()}-{id(out_eoff)}.tmp")
    n = lib.bucket_merge_stream(
        pstream(ns), p64(np.ascontiguousarray(ne, np.int64)),
        p32(np.ascontiguousarray(nl, np.int32)), nk,
        p64(np.ascontiguousarray(nko, np.int64)),
        p32(np.ascontiguousarray(nkl, np.int32)),
        p32(np.ascontiguousarray(nt, np.int32)), n_new,
        pstream(os_), p64(np.ascontiguousarray(oe, np.int64)),
        p32(np.ascontiguousarray(ol, np.int32)), ok_,
        p64(np.ascontiguousarray(oko, np.int64)),
        p32(np.ascontiguousarray(okl, np.int32)),
        p32(np.ascontiguousarray(ot, np.int32)), n_old,
        tmp.encode(), p64(out_eoff), p32(out_elen), p32(out_types),
        pu8(out_keys), p64(out_koff), p32(out_klen),
        pu8(out_hash), p64(out_bytes))
    if n < 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    if n == 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return DiskBucket("", 0, b"\x00" * 32, [], [], 0)
    digest = bytes(out_hash.tobytes())
    path = os.path.join(directory, f"bucket-{digest.hex()}.xdr")
    if protect is not None:
        # register with the store GC BEFORE the file becomes visible
        # under its content-addressed name: from that instant until the
        # spill adopts the result there must be no unprotected window
        protect(digest.hex())
    os.replace(tmp, path)
    keys_blob = out_keys.tobytes()
    _write_sidecar(path, out_eoff[:n], out_elen[:n], out_types[:n],
                   out_koff[:n], out_klen[:n],
                   keys_blob[:int(out_koff[n - 1]) + int(out_klen[n - 1])])
    page_keys = [keys_blob[int(out_koff[i]):
                           int(out_koff[i]) + int(out_klen[i])]
                 for i in range(0, n, PAGE)]
    page_offs = [int(o) for o in out_eoff[:n:PAGE]]
    out = DiskBucket(path, int(n), digest, page_keys, page_offs,
                     int(out_bytes[0]))
    # hand the index off with the bucket: built here (worker thread, off
    # the close path) and adopted atomically with the merge output
    from .index import load_disk_index

    out._index = load_disk_index(_sidecar_path(path), int(n))
    return out


def _table_of(bucket):
    """Entry table for either tier (DiskBucket sidecar / in-memory
    serialized stream); None when the bucket cannot provide one."""
    table = getattr(bucket, "merge_table", None)
    if table is None:
        return None
    return table()


def merge_stream(directory: str, newer_iter, older_iter,
                 merge_entry, protect=None) -> "DiskBucket":
    """Streaming shadow-merge of two sorted (key, entry) iterators into a
    new DiskBucket; ``merge_entry(new, old)`` resolves collisions (the
    in-memory tier's exact function, so results are bitwise identical)."""
    def gen():
        sentinel = object()
        ni = iter(newer_iter)
        oi = iter(older_iter)
        n = next(ni, sentinel)
        o = next(oi, sentinel)
        while n is not sentinel and o is not sentinel:
            if n[0] < o[0]:
                yield n
                n = next(ni, sentinel)
            elif n[0] > o[0]:
                yield o
                o = next(oi, sentinel)
            else:
                merged = merge_entry(n[1], o[1])
                if merged is not None:
                    yield (n[0], merged)
                n = next(ni, sentinel)
                o = next(oi, sentinel)
        while n is not sentinel:
            yield n
            n = next(ni, sentinel)
        while o is not sentinel:
            yield o
            o = next(oi, sentinel)

    return DiskBucket.from_entries(directory, gen(), protect=protect)
