"""BucketList: the 11-level LSM of ledger entries whose cumulative hash is
the ledger's state commitment (ref src/bucket — the 400-line design essay
at src/bucket/BucketList.h; SURVEY.md §2.7).

Shape mirrors the reference: kNumLevels=11, level capacity 4^(level+1)
ledgers of changes (levelSize :208-217), half-full spill cadence
(levelShouldSpill BucketList.h:439).  Each level holds (curr, snap);
add_batch at each close folds the delta into level 0 and cascades spills.

Representation: a Bucket is an immutable sorted tuple of
(key-bytes, BucketEntry-value); its hash is sha256 over the canonical XDR
stream (ref Bucket file hashing).  Merges shadow older entries by key;
INIT+DEAD annihilate (ref INITENTRY/DEADENTRY semantics at protocol 11+).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..crypto import sha256
from ..xdr import types as T

NUM_LEVELS = 11
LEVEL_SIZES = [4 ** (i + 1) for i in range(NUM_LEVELS)]

BET = T.BucketEntryType


def level_size(level: int) -> int:
    return LEVEL_SIZES[level]


def level_half(level: int) -> int:
    return level_size(level) // 2


def level_should_spill(ledger_seq: int, level: int) -> bool:
    """Spill level -> level+1 every half-capacity ledgers
    (ref BucketList::levelShouldSpill)."""
    if level == NUM_LEVELS - 1:
        return False
    return ledger_seq % level_half(level) == 0


class Bucket:
    """Immutable sorted run of (key, BucketEntry)."""

    __slots__ = ("entries", "_hash", "_keys", "_stream", "_table",
                 "_index")

    EMPTY_HASH = b"\x00" * 32

    def __init__(self, entries: Sequence[Tuple[bytes, object]] = ()):
        self.entries = tuple(entries)
        self._hash: Optional[bytes] = None
        self._keys: Optional[Tuple[bytes, ...]] = None
        self._stream: Optional[bytes] = None
        self._table = None
        self._index = None

    def ensure_index(self):
        """The bucket's BucketIndex (bucket/index.py): exact dict for
        small buckets, bloom + bisect for large ones; cached (immutable
        bucket)."""
        if self._index is None and self.entries:
            from .index import MemBucketIndex

            self._index = MemBucketIndex(self.keys)
        return self._index

    @property
    def keys(self) -> Tuple[bytes, ...]:
        # cached: immutable; rebuilt key lists made lookups O(n)
        if self._keys is None:
            self._keys = tuple(k for k, _ in self.entries)
        return self._keys

    def is_empty(self) -> bool:
        return not self.entries

    def _encoded(self) -> bytes:
        """Canonical XDR stream, encoded once per bucket — serialize()
        and merge_table() share it.  hash() deliberately does NOT cache
        the stream: it hashes incrementally, so hash-only buckets (most
        of every close) never pin a second byte-for-byte copy of their
        entries."""
        if self._stream is None:
            self._stream = b"".join(
                T.BucketEntry.encode(e) for _, e in self.entries)
        return self._stream

    def hash(self) -> bytes:
        if not self.entries:
            return self.EMPTY_HASH
        if self._hash is None:
            if self._stream is not None:
                self._hash = sha256(self._stream)
            else:
                import hashlib

                h = hashlib.sha256()
                for _, e in self.entries:
                    h.update(T.BucketEntry.encode(e))
                self._hash = h.digest()
        return self._hash

    def merge_table(self):
        """(stream, eoff, elen, keys, koff, klen, types) for the native
        streaming-merge kernel (same shape DiskBucket.merge_table
        returns), cached on the bucket."""
        if self._table is None:
            import numpy as np

            n = len(self.entries)
            elen = np.zeros(n, np.int32)
            types = np.zeros(n, np.int32)
            parts: List[bytes] = []
            for i, (_, e) in enumerate(self.entries):
                p = T.BucketEntry.encode(e)
                parts.append(p)
                elen[i] = len(p)
                types[i] = e.type
            eoff = np.zeros(n, np.int64)
            if n > 1:
                np.cumsum(elen[:-1], out=eoff[1:])
            if self._stream is None:
                self._stream = b"".join(parts)
            klen = np.zeros(n, np.int32)
            for i, k in enumerate(self.keys):
                klen[i] = len(k)
            koff = np.zeros(n, np.int64)
            if n > 1:
                np.cumsum(klen[:-1], out=koff[1:])
            self._table = (self._stream, eoff, elen, b"".join(self.keys),
                           koff, klen, types)
        return self._table

    @classmethod
    def fresh(cls, changes: Iterable[Tuple[bytes, Optional[object], bool]],
              ledger_version: int) -> "Bucket":
        """Fresh level-0 bucket from one ledger's delta of
        (key, entry-or-None, existed-before) triples: true creations become
        INITENTRY, updates of pre-existing entries LIVEENTRY, deletions
        DEADENTRY (protocol 11+ semantics).  The created/updated
        distinction matters: DEAD annihilates only against INIT — a DEAD
        over a LIVE must persist as a tombstone shadowing deeper levels."""
        out = []
        for kb, entry, existed in sorted(
                changes, key=lambda c: c[0]):
            if entry is None:
                out.append((kb, T.BucketEntry.make(
                    BET.DEADENTRY, T.LedgerKey.decode(kb))))
            elif existed:
                out.append((kb, T.BucketEntry.make(BET.LIVEENTRY, entry)))
            else:
                out.append((kb, T.BucketEntry.make(BET.INITENTRY, entry)))
        return cls(out)

    def serialize(self) -> bytes:
        """Canonical XDR stream of BucketEntry (the on-disk/archive file
        format, ref BucketOutputIterator)."""
        return self._encoded()

    @classmethod
    def deserialize(cls, data: bytes) -> "Bucket":
        """Parse an XDR BucketEntry stream back into a Bucket (ref
        BucketInputIterator); keys recomputed from the entries."""
        from ..ledger.ledger_txn import entry_to_key, key_bytes
        from ..xdr.runtime import Reader

        out: List[Tuple[bytes, object]] = []
        r = Reader(data)
        while not r.done():
            e = T.BucketEntry.unpack(r)
            if e.type == BET.DEADENTRY:
                kb = T.LedgerKey.encode(e.value)
            else:
                kb = key_bytes(entry_to_key(e.value))
            out.append((kb, e))
        return cls(out)

    @classmethod
    def merge(cls, newer: "Bucket", older: "Bucket") -> "Bucket":
        """Two-way sorted merge, newer shadowing older by key; INIT over
        DEAD(INIT-origin) annihilation per the reference's merge logic.

        Large merges run through the native C++ kernel
        (native/bucket_merge.cpp — the reference's background-worker
        compute tier); small ones and toolchain-less hosts use the
        Python loop, which is also the differential oracle."""
        # empty-side fast paths: no collisions possible, entries unchanged
        if not older.entries:
            return newer
        if not newer.entries:
            return older
        if len(newer) + len(older) >= 256:
            out = _native_merge(newer, older)
            if out is not None:
                return cls(out)
        return cls(cls._merge_py(newer, older))

    @staticmethod
    def _merge_py(newer: "Bucket",
                  older: "Bucket") -> List[Tuple[bytes, object]]:
        out: List[Tuple[bytes, object]] = []
        i = j = 0
        ne, oe = newer.entries, older.entries
        while i < len(ne) and j < len(oe):
            if ne[i][0] < oe[j][0]:
                out.append(ne[i])
                i += 1
            elif ne[i][0] > oe[j][0]:
                out.append(oe[j])
                j += 1
            else:
                merged = _merge_entry(ne[i][1], oe[j][1])
                if merged is not None:
                    out.append((ne[i][0], merged))
                i += 1
                j += 1
        out.extend(ne[i:])
        out.extend(oe[j:])
        return out

    def __len__(self) -> int:
        return len(self.entries)

    def iter_entries(self):
        return iter(self.entries)

    def get(self, kb: bytes):
        return _bucket_find(self, kb)


def _native_merge(newer: "Bucket", older: "Bucket"):
    """Run the merge through native/bucket_merge.cpp; None if the native
    library is unavailable.  Entry-type tags map as LIVE=0/DEAD=1/INIT=2
    (the XDR BucketEntryType values)."""
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    def table(bucket):
        keys = b"".join(bucket.keys)
        off = np.zeros(len(bucket.entries), np.int64)
        ln = np.zeros(len(bucket.entries), np.int32)
        ty = np.zeros(len(bucket.entries), np.int32)
        pos = 0
        for idx, (kb, e) in enumerate(bucket.entries):
            off[idx] = pos
            ln[idx] = len(kb)
            ty[idx] = e.type
            pos += len(kb)
        return keys, off, ln, ty

    nk, noff, nlen, nty = table(newer)
    ok_, ooff, olen, oty = table(older)
    cap = len(newer) + len(older)
    out_side = np.zeros(cap, np.int32)
    out_idx = np.zeros(cap, np.int64)
    out_type = np.zeros(cap, np.int32)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n = lib.bucket_merge(
        nk, p64(noff), p32(nlen), p32(nty), len(newer),
        ok_, p64(ooff), p32(olen), p32(oty), len(older),
        p32(out_side), p64(out_idx), p32(out_type))
    out: List[Tuple[bytes, object]] = []
    for w in range(n):
        src = newer.entries if out_side[w] == 0 else older.entries
        kb, e = src[out_idx[w]]
        t = int(out_type[w])
        if t >= 0 and t != e.type:
            e = T.BucketEntry.make(t, e.value)
        out.append((kb, e))
    return out


def _merge_entry(new, old):
    """Resolve a key collision between a newer and older bucket entry
    (ref Bucket::mergeCasesWithEqualKeys):
    - DEAD over INIT -> annihilate (entry never existed at this level)
    - DEAD over LIVE/DEAD -> DEAD
    - LIVE/INIT over INIT -> INIT with the new value (still 'created here')
    - INIT over DEAD -> LIVE (delete + recreate = net update: the INIT must
      NOT survive or a later DEAD would annihilate it and resurrect the
      original entry from a deeper level)
    - otherwise keep the newer."""
    nt, ot = new.type, old.type
    if nt == BET.DEADENTRY and ot == BET.INITENTRY:
        return None
    if nt in (BET.LIVEENTRY, BET.INITENTRY) and ot == BET.INITENTRY:
        return T.BucketEntry.make(BET.INITENTRY, new.value)
    if nt == BET.INITENTRY and ot == BET.DEADENTRY:
        return T.BucketEntry.make(BET.LIVEENTRY, new.value)
    return new


def merge_buckets(newer, older, disk_dir: Optional[str] = None,
                  protect=None):
    """Tier-dispatching merge: when ``disk_dir`` is set the result is a
    DiskBucket built by a streaming merge (bounded memory); otherwise the
    in-memory merge.  Mixed-tier inputs stream through iter_entries either
    way; collision rules are the shared _merge_entry, so both tiers are
    bitwise identical.  ``protect(hash_hex)`` fires before a disk result
    becomes visible (GC registration for background workers)."""
    from .disk_bucket import DiskBucket, merge_disk_native, merge_stream

    if disk_dir is not None:
        if older.is_empty() and isinstance(newer, DiskBucket):
            return newer
        if newer.is_empty() and isinstance(older, DiskBucket):
            return older
        # the deep-level hot path: one GIL-free native call does the
        # whole merge (compare/copy/write/hash); the Python streaming
        # merge below is the differential oracle + no-toolchain fallback
        out = merge_disk_native(disk_dir, newer, older, protect=protect)
        if out is not None:
            return out
        return merge_stream(disk_dir, newer.iter_entries(),
                            older.iter_entries(), _merge_entry,
                            protect=protect)
    if isinstance(newer, DiskBucket) or isinstance(older, DiskBucket):
        # pulling a disk bucket back to memory happens only in small/test
        # configurations; keep semantics identical
        newer = newer if isinstance(newer, Bucket) else \
            Bucket(tuple(newer.iter_entries()))
        older = older if isinstance(older, Bucket) else \
            Bucket(tuple(older.iter_entries()))
    return Bucket.merge(newer, older)


class BucketLevel:
    __slots__ = ("curr", "snap")

    def __init__(self):
        self.curr = Bucket()
        self.snap = Bucket()

    def hash(self) -> bytes:
        return sha256(self.curr.hash() + self.snap.hash())


class BucketList:
    # levels >= DISK_LEVEL store their buckets on disk (sparse-indexed
    # XDR files, bucket/disk_bucket.py) when a disk_dir is configured;
    # shallower levels are small and stay in memory (ref BucketListDB:
    # hot levels in memory, deep levels indexed files)
    DISK_LEVEL = 4

    def __init__(self, executor=None, disk_dir: Optional[str] = None,
                 disk_level: Optional[int] = None):
        self.levels = [BucketLevel() for _ in range(NUM_LEVELS)]
        self.disk_dir = disk_dir
        if disk_level is not None:
            self.disk_level = disk_level
        else:
            self.disk_level = self.DISK_LEVEL
        # FutureBucket equivalent (ref src/bucket/FutureBucket.cpp): a
        # level's next spill-merge inputs are fully determined at its
        # PREVIOUS spill (snap and next.curr only change then), so the
        # merge runs on a worker thread during the half-capacity window
        # between spills and is resolved at spill time.  Every spill
        # stages its successor — including the every-4th "coincident"
        # spill where level+1 spills at the same seq: the cascade
        # (deepest-first) empties next.curr before this level's snap
        # arrives, so the staged partner is predicted EMPTY and the
        # staged work is re-tiering snap alone (curr_ref None below).
        # A close therefore only ever blocks on *this level's* future;
        # it never re-runs a merge inline in steady state.  Unlike the
        # reference — whose in-flight merges commit one spill late and
        # therefore shape the canonical hash schedule — results here are
        # bitwise identical to the synchronous merge, so the hash chain
        # does not depend on whether (or when) backgrounding happened:
        # restart-mid-merge simply falls back to the synchronous path.
        self.executor = executor
        # level -> (snap_ref, curr_ref_or_None, future); curr_ref None
        # means "staged against a predicted-empty curr"
        self._futures: Dict[int, Tuple[Bucket, Optional[Bucket],
                                       object]] = {}
        # hex hashes of background-merge output files not yet adopted:
        # workers register BEFORE renaming the file into the store, the
        # main thread deregisters at adoption (result then in the live
        # set) or when a mismatched staged future completes — so there is
        # no instant at which a GC pass can see an unprotected,
        # not-yet-live merge output
        import threading as _threading

        from ..utils.lockdep import register_lock

        self._bg_lock = register_lock(_threading.Lock(), "bucket.bg")
        self._bg_outputs: set = set()  # guarded-by: _bg_lock
        # seconds on the workers of the background merges finished
        # since the last take_merge_stats (the ledger's record)
        self._bg_merge_s = 0.0  # guarded-by: _bg_lock
        # merge-pipeline observability (surfaced via /metrics and bench):
        # sync_fallback_merges MUST stay 0 in steady state — it counts
        # closes that had to run a non-trivial merge inline
        self.stats: Dict[str, float] = {
            "staged_merges": 0,
            "resolved_merges": 0,
            "sync_fallback_merges": 0,
            "spill_wait_s": 0.0,
            "hash_s": 0.0,
            # BucketListDB read-path counters (bucket/index.py):
            # bucket_probes / point_reads is the probes-per-read figure
            # the READ_BENCH artifact tracks (linear scan: ~#buckets)
            "point_reads": 0,
            "bucket_probes": 0,
            "bloom_checks": 0,
            "bloom_false_positives": 0,
            "index_build_s": 0.0,
        }
        # bloom-first point reads (default on); read_bench flips this
        # off for the linear-scan baseline and the hash-parity check
        self.index_enabled = True
        # flight recorder (utils/tracing): BucketManager re-points this
        # at the owning app's tracer; spans staged here cross the merge
        # worker threads with explicit parent tokens
        from ..utils.tracing import NULL_TRACER

        self.tracer = NULL_TRACER

    def hash(self) -> bytes:
        """Cumulative commitment: sha256 over all level hashes
        (ref BucketList::getHash)."""
        return sha256(b"".join(lv.hash() for lv in self.levels))

    def add_batch(self, ledger_seq: int,
                  changes: Iterable[Tuple[bytes, Optional[object]]],
                  ledger_version: int = 19) -> bytes:
        """Fold one close's delta in; cascade spills (ref addBatch
        BucketList.h:507).  Returns the new cumulative hash."""
        spilled: List[int] = []
        # cascade from deepest to shallowest so spills don't double-move
        for level in range(NUM_LEVELS - 2, -1, -1):
            if level_should_spill(ledger_seq, level):
                lv = self.levels[level]
                nxt = self.levels[level + 1]
                # snap spills into next.curr (merge); curr becomes snap
                nxt.curr = self._resolve_merge(level, lv.snap, nxt.curr)
                lv.snap = lv.curr
                lv.curr = Bucket()
                spilled.append(level)
        fresh = Bucket.fresh(changes, ledger_version)
        self.levels[0].curr = Bucket.merge(fresh, self.levels[0].curr)
        if self.executor is not None:
            for level in spilled:
                self._stage_next_merge(level, ledger_seq)
        from ..utils.tracing import stopwatch

        # index the close's new level-0 bucket at creation time (spill
        # outputs are indexed by the merge that built them); the cost is
        # tracked so READ_BENCH can prove it stays <10% of close p50
        if self.index_enabled:
            with stopwatch() as sw:
                self.levels[0].curr.ensure_index()
            self.stats["index_build_s"] += sw.seconds

        with self.tracer.span("bucket.hash"), stopwatch() as sw:
            out = self.hash()
        self.stats["hash_s"] += sw.seconds
        return out

    def _stage_next_merge(self, level: int, ledger_seq: int) -> None:
        """Stage this level's NEXT spill merge now (FutureBucket promise
        chain): between spills of `level`, its snap is frozen and
        next.curr only changes at `level`'s own spills, so the inputs are
        exactly knowable.  The one wrinkle is the every-4th spill where
        level+1 spills at the same future seq — the deepest-first cascade
        will have emptied next.curr by then, so the right staged work is
        re-tiering snap against an EMPTY partner (curr_ref None)."""
        snap = self.levels[level].snap
        nxt_spill = ledger_seq + level_half(level)
        # cross-thread span parenting: the worker's merge span hangs off
        # whatever span is open on the staging (close) thread right now
        parent = self.tracer.current_id()
        if level_should_spill(nxt_spill, level + 1):
            curr: Optional[Bucket] = None
            fut = self.executor.submit(self._bg_merge, level, snap,
                                       Bucket(), parent)
        else:
            curr = self.levels[level + 1].curr
            fut = self.executor.submit(self._bg_merge, level, snap, curr,
                                       parent)
        self._futures[level] = (snap, curr, fut)
        self.stats["staged_merges"] += 1

    def _resolve_merge(self, level: int, snap: Bucket,
                       curr: Bucket) -> Bucket:
        """Adopt the background merge staged at this level's previous
        spill when its captured inputs are still the live ones; fall back
        to a synchronous merge otherwise.  In steady state the fallback
        never fires (every spill stages its successor, coincident spills
        included) — only a first-spill-after-restore or executor-less
        list merges inline, and only non-trivial inline merges count as
        sync fallbacks."""
        from ..utils.tracing import stopwatch

        staged = self._futures.pop(level, None)
        if staged is not None:
            snap_ref, curr_ref, fut = staged
            ok = snap_ref is snap and (
                curr_ref is curr if curr_ref is not None
                else curr.is_empty())
            if ok:
                with self.tracer.span("bucket.spill.wait", level=level), \
                        stopwatch() as sw:
                    out = fut.result()
                self.stats["spill_wait_s"] += sw.seconds
                self.stats["resolved_merges"] += 1
                self._unprotect(out)
                return out
            # mismatched staged work: release its output to GC once the
            # worker is done with it (may still be running)
            fut.add_done_callback(self._unprotect_future)
        if self.executor is not None and \
                not (snap.is_empty() and curr.is_empty()):
            self.stats["sync_fallback_merges"] += 1
            from ..utils.logging import get_logger

            get_logger("Bucket").warning(
                "sync-fallback merge at level %d (%d+%d entries) — "
                "staged future missed its inputs", level, len(snap),
                len(curr))
        with self.tracer.span("bucket.merge.sync", level=level):
            out = merge_buckets(snap, curr, self._merge_dir(level + 1))
        if self.index_enabled and not out.is_empty():
            with stopwatch() as sw:
                out.ensure_index()
            self.stats["index_build_s"] += sw.seconds
        return out

    def _protect_bg_output(self, hash_hex: str) -> None:
        with self._bg_lock:
            self._bg_outputs.add(hash_hex)

    def _unprotect(self, bucket) -> None:
        try:
            hh = bucket.hash().hex()
        except Exception:
            from ..utils.logging import get_logger

            # a merge output without a readable hash cannot be released
            # from GC protection — say so; the entry leaks until restart
            get_logger("Bucket").warning(
                "unprotect: merge output %r has no hash; GC protection "
                "entry retained", bucket)
            return
        with self._bg_lock:
            self._bg_outputs.discard(hh)

    def _unprotect_future(self, fut) -> None:
        try:
            bucket = fut.result()
        except Exception as e:
            from ..utils.logging import get_logger

            # the staged merge failed; the close path notices via its
            # own sync fallback — here only the GC release is skipped
            get_logger("Bucket").debug(
                "unprotect skipped: staged merge failed (%s)", e)
            return
        self._unprotect(bucket)

    def _merge_dir(self, target_level: int) -> Optional[str]:
        """Directory for the merge result's tier (None = in-memory)."""
        if self.disk_dir is not None and target_level >= self.disk_level:
            return self.disk_dir
        return None

    def _bg_merge(self, level: int, newer, older, parent_span=None):
        # the worker-pool span: explicitly parented to the close-thread
        # span that staged this merge (the flight recorder's
        # cross-thread linkage)
        with self.tracer.span("bucket.merge.background",
                              parent=parent_span, level=level,
                              n_newer=len(newer), n_older=len(older)) as sp:
            out = merge_buckets(newer, older, self._merge_dir(level + 1),
                                protect=self._protect_bg_output)
            out.hash()  # pre-hash too: off the close critical path
            if self.index_enabled and not out.is_empty():
                out.ensure_index()  # index handed off with the output
        with self._bg_lock:
            self._bg_merge_s += sp.seconds
        return out

    def take_merge_stats(self) -> float:
        """The seconds on the workers of the background merges finished
        since the previous call."""
        with self._bg_lock:
            seconds, self._bg_merge_s = self._bg_merge_s, 0.0
        return seconds

    def pending_merge_hashes(self) -> set:
        """Hex hashes of background merge outputs written to the store
        but not yet adopted — the bucket-store GC must not delete these
        (registered by the worker BEFORE the file's rename, removed at
        adoption, so no scan can catch an unprotected window; the spill
        that adopts them may be many closes away)."""
        with self._bg_lock:
            return set(self._bg_outputs)

    # -- state access (the BucketListDB read path) --------------------------

    def _buckets_shallow_first(self):
        for lv in self.levels:
            for bucket in (lv.curr, lv.snap):
                if not bucket.is_empty():
                    yield bucket

    def get_entry_record(self, kb: bytes):
        """Most-recent BucketEntry for a key across all levels (None when
        no level mentions it; a DEADENTRY result is an authoritative
        "deleted").  With indexes on, each bucket's bloom filter is
        consulted first and only filter hits probe the bucket's data —
        ~1 probe/read instead of a scan of all 22 buckets (ref
        src/bucket/readme.md BucketListDB design, BucketIndexImpl)."""
        st = self.stats
        st["point_reads"] += 1
        if not self.index_enabled:
            for bucket in self._buckets_shallow_first():
                st["bucket_probes"] += 1
                e = bucket.get(kb)
                if e is not None:
                    return e
            return None
        for bucket in self._buckets_shallow_first():
            idx = bucket.ensure_index()
            if idx is None:
                continue
            st["bloom_checks"] += 1
            if not idx.may_contain(kb):
                continue
            st["bucket_probes"] += 1
            e = idx.find(bucket, kb)
            if e is None:
                st["bloom_false_positives"] += 1
                continue
            return e
        return None

    def get_entry(self, kb: bytes):
        """Most-recent live entry for a key (None if dead or absent)."""
        e = self.get_entry_record(kb)
        if e is None or e.type == BET.DEADENTRY:
            return None
        return e.value

    def get_entries(self, kbs) -> Dict[bytes, Optional[object]]:
        """Batched point lookup: kb -> live entry value or None, walking
        the levels once with the whole probe set (the prefetch feed for
        LedgerTxnRoot; ref BucketListDB bulk load + the native
        bucket_lower_bound batch kernel)."""
        return self._get_entries_walk(
            list(self._buckets_shallow_first()), kbs, self.stats,
            self.index_enabled)

    def snapshot_read_buckets(self) -> list:
        """Stable bucket list for an off-thread batched lookup
        (close-pipeline footprint prefetch): bucket objects are
        immutable, only the LEVEL SLOTS mutate at add_batch — so a
        caller on the main thread snapshots the slots (indexes built
        here, not on the worker) and the worker walks the snapshot."""
        buckets = list(self._buckets_shallow_first())
        if self.index_enabled:
            for bucket in buckets:
                bucket.ensure_index()
        return buckets

    def get_entries_from(self, buckets: list, kbs
                         ) -> Dict[bytes, Optional[object]]:
        """``get_entries`` over a pre-snapshotted bucket list, with
        thread-local stats (worker-safe: never touches the live level
        slots or the shared stats dict)."""
        local = {"point_reads": 0, "bucket_probes": 0, "bloom_checks": 0,
                 "bloom_false_positives": 0}
        return self._get_entries_walk(buckets, kbs, local,
                                      self.index_enabled)

    @staticmethod
    def _get_entries_walk(buckets: list, kbs, st: Dict[str, float],
                          index_enabled: bool
                          ) -> Dict[bytes, Optional[object]]:
        pending = list(dict.fromkeys(kbs))
        out: Dict[bytes, Optional[object]] = {}
        st["point_reads"] += len(pending)
        for bucket in buckets:
            if not pending:
                break
            if index_enabled:
                idx = bucket.ensure_index()
                if idx is None:
                    continue
                st["bloom_checks"] += len(pending)
                candidates = [kb for kb, hit in
                              zip(pending, idx.check_batch(pending))
                              if hit]
                if not candidates:
                    continue
                st["bucket_probes"] += len(candidates)
                found = idx.find_batch(bucket, candidates)
            else:
                candidates = pending
                st["bucket_probes"] += len(candidates)
                found = [bucket.get(kb) for kb in candidates]
            hits = set()
            for kb, e in zip(candidates, found):
                if e is None:
                    if index_enabled:
                        st["bloom_false_positives"] += 1
                    continue
                out[kb] = (None if e.type == BET.DEADENTRY else e.value)
                hits.add(kb)
            if hits:
                pending = [kb for kb in pending if kb not in hits]
        for kb in pending:
            out[kb] = None
        return out

    def ensure_indexes(self) -> None:
        """Build any missing bucket indexes now (restore/adoption path);
        build time lands in stats["index_build_s"]."""
        from ..utils.tracing import stopwatch

        with stopwatch() as sw:
            for bucket in self._buckets_shallow_first():
                bucket.ensure_index()
        self.stats["index_build_s"] += sw.seconds

    def index_memory_bytes(self) -> int:
        """Resident bytes of all built indexes (bloom words + dict
        estimates; memmapped tables count only their bloom)."""
        total = 0
        for bucket in self._buckets_shallow_first():
            idx = getattr(bucket, "_index", None)
            if idx is not None:
                total += idx.nbytes
        return total

    def iter_live_entries(self):
        """Stream the live entry set in key order with O(#buckets) memory:
        a heap-merge over all 22 sorted runs, shallower buckets shadowing
        deeper ones per key (catchup's ApplyBucketsWork without
        materializing the ledger; the whole point of the disk tier)."""
        import heapq

        def run(bucket, prio):
            for kb, e in bucket.iter_entries():
                yield kb, prio, e

        runs = []
        prio = 0
        for lv in self.levels:
            for bucket in (lv.curr, lv.snap):
                if not bucket.is_empty():
                    runs.append(run(bucket, prio))
                prio += 1
        cur_key = None
        for kb, _, e in heapq.merge(*runs):
            if kb == cur_key:
                continue  # shadowed by a shallower bucket
            cur_key = kb
            if e.type != BET.DEADENTRY:
                yield kb, e.value

    def all_live_entries(self) -> Dict[bytes, object]:
        """Flatten to the live entry set (small states / tests; catchup
        streams via iter_live_entries)."""
        return dict(self.iter_live_entries())

    # -- persistence / restore ---------------------------------------------

    def level_hashes(self) -> List[Tuple[str, str]]:
        """[(curr_hex, snap_hex)] per level — the HAS bucket list."""
        return [(lv.curr.hash().hex(), lv.snap.hash().hex())
                for lv in self.levels]

    @classmethod
    def restore(cls, level_hashes: Sequence[Tuple[str, str]],
                loader, disk_dir: Optional[str] = None,
                disk_level: Optional[int] = None) -> "BucketList":
        """Rebuild from level hashes + a loader(hash_hex) -> bytes of the
        serialized bucket (ref AssumeStateWork restoring the bucket list
        from a HAS).  With a disk_dir, deep levels whose files are already
        in the store are INDEXED in place (DiskBucket.open) instead of
        being materialized."""
        from .disk_bucket import DiskBucket

        bl = cls(disk_dir=disk_dir, disk_level=disk_level)
        cache: Dict[str, object] = {}

        def load(hh: str, level: int):
            if hh == "00" * 32:
                return Bucket()
            if hh not in cache:
                if disk_dir is not None and level >= bl.disk_level:
                    import os

                    path = os.path.join(disk_dir, f"bucket-{hh}.xdr")
                    if os.path.exists(path):
                        cache[hh] = DiskBucket.open(path, bytes.fromhex(hh))
                        return cache[hh]
                data = loader(hh)
                if data is None:
                    raise RuntimeError(f"missing bucket {hh}")
                try:
                    b = Bucket.deserialize(data)
                except Exception as e:
                    raise RuntimeError(
                        f"corrupt bucket {hh}: {e}") from e
                if b.hash().hex() != hh:
                    raise RuntimeError(f"bucket hash mismatch for {hh}")
                cache[hh] = b
            return cache[hh]

        for level, (lv, (ch, sh)) in enumerate(
                zip(bl.levels, level_hashes)):
            lv.curr = load(ch, level)
            lv.snap = load(sh, level)
        return bl


def _bucket_find(bucket: Bucket, kb: bytes):
    """Binary search by key (cached keys tuple)."""
    import bisect

    keys = bucket.keys
    i = bisect.bisect_left(keys, kb)
    if i < len(keys) and keys[i] == kb:
        return bucket.entries[i][1]
    return None


class BucketManager:
    """Owns the bucket list + the on-disk bucket store (ref
    src/bucket/BucketManagerImpl.cpp).  Buckets are content-addressed
    files <dir>/bucket-<hex>.xdr so a node restart (or catchup) can
    reassume state from the persisted level hashes."""

    def __init__(self, app=None, bucket_dir: Optional[str] = None):
        self.app = app
        use_bg = bool(getattr(getattr(app, "config", None),
                              "BACKGROUND_BUCKET_MERGES", False))
        self.executor = None
        if use_bg:
            from concurrent.futures import ThreadPoolExecutor

            # the reference's merge worker pool (ApplicationImpl worker
            # threads cranking FutureBucket merges)
            self.executor = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="bucket-merge")
        self.bucket_dir = bucket_dir
        disk_level = getattr(getattr(app, "config", None),
                             "DISK_BUCKET_LEVEL", None)
        self.bucket_list = BucketList(self.executor, disk_dir=bucket_dir,
                                      disk_level=disk_level)
        self._attach_tracer()
        if bucket_dir:
            import os

            os.makedirs(bucket_dir, exist_ok=True)
        # store bookkeeping below is shared between the close thread
        # (_persist_new_buckets after every add_batch) and the close
        # pipeline's tail worker (gc_unreferenced): the lock serializes
        # the exists-check/rename of adoption against GC's deletions,
        # so a spill re-producing a previously-collected content hash
        # can never lose its file to a concurrently-firing delete
        import threading as _threading

        from ..utils.lockdep import register_lock

        self._gc_lock = register_lock(_threading.Lock(), "bucket.gc")
        self._saved: set = set()        # guarded-by: _gc_lock
        # two-pass GC tombstones: a file is only deleted after TWO
        # consecutive passes see it unreferenced, so a background merge
        # renaming its output between the dir scan and the futures check
        # can never lose the file it just wrote
        self._gc_candidates: set = set()  # guarded-by: _gc_lock

    def _attach_tracer(self) -> None:
        """Point the (possibly just-swapped) bucket list at the owning
        app's flight recorder."""
        from ..utils.tracing import tracer_of

        self.bucket_list.tracer = tracer_of(self)

    def add_batch(self, ledger_seq: int, changes) -> bytes:
        h = self.bucket_list.add_batch(ledger_seq, changes)
        if self.bucket_dir:
            self._persist_new_buckets()
        return h

    def get_bucket_list_hash(self) -> bytes:
        return self.bucket_list.hash()

    def snapshot_state(self) -> Dict[bytes, object]:
        return self.bucket_list.all_live_entries()

    # -- disk store ---------------------------------------------------------

    def _bucket_path(self, hh: str) -> str:
        import os

        return os.path.join(self.bucket_dir, f"bucket-{hh}.xdr")

    def _persist_new_buckets(self) -> None:
        """Write newly-appeared buckets to disk.  Deletion of
        no-longer-referenced files is deliberately NOT done here: GC runs
        via gc_unreferenced() only after the new level hashes are durably
        committed (LedgerManager._store_bucket_state), else a crash
        between the two leaves persisted hashes pointing at deleted
        files."""
        import os

        from .disk_bucket import DiskBucket

        with self._gc_lock:
            # serialized against gc_unreferenced's delete loop: if GC
            # collected this hash earlier, it also dropped it from
            # _saved, so the file is simply rewritten here
            for lv in self.bucket_list.levels:
                for b in (lv.curr, lv.snap):
                    hh = b.hash().hex()
                    if hh == "00" * 32 or hh in self._saved:
                        continue
                    if isinstance(b, DiskBucket):
                        # already a content-addressed file in the store
                        self._saved.add(hh)
                        continue
                    path = self._bucket_path(hh)
                    if not os.path.exists(path):
                        tmp = path + ".tmp"
                        with open(tmp, "wb") as f:
                            f.write(b.serialize())
                        os.replace(tmp, path)
                    self._saved.add(hh)

    def gc_unreferenced(self, extra_live=None) -> None:
        """Delete bucket files the current (durably committed) bucket list
        no longer references (ref forgetUnreferencedBuckets).  Completed
        background-merge outputs awaiting adoption are protected, and
        deletion is two-pass (see _gc_candidates) so an in-flight worker
        renaming its output concurrently can never race a delete.

        ``extra_live``: additional hex hashes to protect — the pipelined
        close's tail passes the level-hash snapshot it just persisted,
        so nothing the DURABLE state references is ever collected even
        if the next close's spills already replaced it in the live
        list."""
        import os

        if self.bucket_dir is None:
            return
        live = {b.hash().hex()
                for lv in self.bucket_list.levels
                for b in (lv.curr, lv.snap)}
        live |= self.bucket_list.pending_merge_hashes()
        if extra_live:
            live |= set(extra_live)
        # scan the directory (not just _saved): background merges write
        # content-addressed files that may never be adopted (discarded
        # futures, restarts) and would otherwise leak forever
        try:
            names = os.listdir(self.bucket_dir)
        except OSError:
            names = []
        xdr_names = {n for n in names
                     if n.startswith("bucket-") and n.endswith(".xdr")}
        candidates = set()
        for name in sorted(xdr_names):
            hh = name[len("bucket-"):-len(".xdr")]
            if hh in live:
                continue
            candidates.add(name)
        # orphan sidecars (stream already collected earlier)
        for name in names:
            if name.endswith(".xdr.idx") and name[:-4] not in xdr_names:
                candidates.add(name)
        # temp files abandoned by crashed/killed processes: every writer
        # embeds its pid (.tmp-<pid>-..., .merge-<pid>-....tmp,
        # ....idx.<pid>.tmp) — reap only when that pid is gone, so an
        # in-flight worker of a live process is never raced
        self._reap_dead_tmp(names)
        with self._gc_lock:
            # re-check liveness at delete time: a spill on the close
            # thread may have re-produced one of these content hashes
            # since the scan above.  Together with the lock (adoption's
            # exists-check/skip in _persist_new_buckets serializes
            # against this loop, and a file deleted here is simply
            # re-written there because its hash left _saved) no
            # interleaving can lose a live bucket's file.
            live_now = {b.hash().hex()
                        for lv in self.bucket_list.levels
                        for b in (lv.curr, lv.snap)}
            live_now |= self.bucket_list.pending_merge_hashes()
            for name in candidates & self._gc_candidates:
                if name.endswith(".xdr"):
                    hh = name[len("bucket-"):-len(".xdr")]
                    if hh in live_now:
                        continue
                    self._saved.discard(hh)
                for victim in (name, name + ".idx"):
                    try:
                        os.remove(os.path.join(self.bucket_dir, victim))
                    except OSError:
                        pass
            self._gc_candidates = candidates - self._gc_candidates

    @staticmethod
    def _tmp_owner_pid(name: str):
        import re

        m = (re.match(r"\.tmp-(\d+)-", name)
             or re.match(r"\.merge-(\d+)-.*\.tmp$", name)
             or re.search(r"\.idx\.(\d+)\.tmp$", name))
        return int(m.group(1)) if m else None

    def _reap_dead_tmp(self, names) -> None:
        import os

        for name in names:
            pid = self._tmp_owner_pid(name)
            if pid is None or pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
                continue  # owner still alive: its write may be in flight
            except ProcessLookupError:
                pass
            except OSError:
                continue  # exists but not ours to signal: leave it
            try:
                os.remove(os.path.join(self.bucket_dir, name))
            except OSError:
                pass

    def load_bucket_bytes(self, hh: str) -> Optional[bytes]:
        if hh == "00" * 32:
            return b""
        try:
            with open(self._bucket_path(hh), "rb") as f:
                return f.read()
        except (FileNotFoundError, TypeError):
            return None

    def restore_from_level_hashes(
            self, level_hashes: Sequence[Tuple[str, str]]) -> None:
        self.bucket_list = BucketList.restore(
            level_hashes, self.load_bucket_bytes,
            disk_dir=self.bucket_dir,
            disk_level=getattr(getattr(self.app, "config", None),
                               "DISK_BUCKET_LEVEL", None))
        self.bucket_list.executor = self.executor
        self._attach_tracer()
        with self._gc_lock:
            self._saved = {hh for pair in level_hashes for hh in pair
                           if hh != "00" * 32}

    def assume_bucket_list(self, bucket_list: BucketList) -> None:
        """Adopt a bucket list built by catchup; persist its buckets and
        re-attach the node's storage tier so later spill merges keep
        going to disk."""
        self.bucket_list = bucket_list
        self.bucket_list.executor = self.executor
        self._attach_tracer()
        self.bucket_list.disk_dir = self.bucket_dir
        disk_level = getattr(getattr(self.app, "config", None),
                             "DISK_BUCKET_LEVEL", None)
        if disk_level is not None:
            self.bucket_list.disk_level = disk_level
        if self.bucket_dir:
            self._persist_new_buckets()

    def shutdown(self) -> None:
        if self.executor is not None:
            self.executor.shutdown(wait=False, cancel_futures=True)
