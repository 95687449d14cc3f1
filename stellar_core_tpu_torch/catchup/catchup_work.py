"""Catchup works: rejoin the network from history archives
(ref src/catchup/CatchupWork.h:44-108, VerifyLedgerChainWork.cpp,
ApplyBucketsWork/ApplyCheckpointWork, src/historywork's download works).

The Work DAG (parallel since r17 — downloads are ThreadedWork children
of BatchWorks, so `batch_size` transfers run concurrently on the
scheduler's WorkerPool, each with its own retry/backoff):

    CatchupWork
      stage has      GetHistoryArchiveStateWork          (minimal only)
      stage download DownloadVerifyLedgerChainWork ──┐   concurrent
                     DownloadBucketsWork             ├── children
                     DownloadTxSetsWork (tail range) ─┘
      stage apply    ApplyBucketsWork                    (minimal only)
      stage replay   ApplyCheckpointsWork

Verification chain: every downloaded header is hashed and chain-linked
back from a TRUSTED hash (a live-consensus-attested previousLedgerHash
supplied by the CatchupManager's buffer), every bucket's sha256 is
checked against its content address before install, and the restored
bucket list's hash must equal the verified header's bucketListHash —
an archive can fail catchup but cannot forge state.
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional

from ..bucket.bucket_list import BucketList
from ..ledger.ledger_txn import LedgerTxn
from ..work.work import (BasicWork, BatchWork, State, ThreadedWork, Work,
                         WorkSequence)
from ..xdr import types as T
from ..xdr import xdr_sha256
from .. import history as H


class CatchupConfiguration:
    """MINIMAL: buckets at the target checkpoint only; COMPLETE: replay
    every ledger from the local LCL (ref CatchupConfiguration modes)."""

    MINIMAL = "minimal"
    COMPLETE = "complete"

    def __init__(self, to_ledger: int, mode: str = MINIMAL):
        self.to_ledger = to_ledger
        self.mode = mode


def _archive_pool(app, archive):
    """The worker pool downloads from this archive may use: the app
    scheduler's pool, unless the transport is marked not thread-safe
    (CommandArchive polls the main-thread ProcessManager)."""
    if not getattr(archive, "thread_safe", True):
        return None
    ws = getattr(app, "work_scheduler", None)
    return getattr(ws, "worker_pool", None)


class GetHistoryArchiveStateWork(BasicWork):
    def __init__(self, app, archive, checkpoint: Optional[int] = None,
                 clock=None, retry_backoff: float = 0.0):
        super().__init__("get-has", clock=clock,
                         retry_backoff=retry_backoff)
        self.app = app
        self.archive = archive
        self.checkpoint = checkpoint
        self.has: Optional[H.HistoryArchiveState] = None

    def on_run(self) -> State:
        if self.checkpoint is None:
            self.has = self.archive.get_root_has()
        else:
            self.has = self.archive.get_checkpoint_has(self.checkpoint)
        return State.SUCCESS if self.has is not None else State.FAILURE


class GetCheckpointHeadersWork(ThreadedWork):
    """Fetch + parse one checkpoint's header file, verifying each entry's
    stored hash and the intra-chunk chain links on the worker thread.
    Results land in the parent's shared seq->entry dict from the cranking
    thread (on_complete), so no cross-thread mutation."""

    def __init__(self, app, archive, checkpoint: int, out: Dict[int, object],
                 pool=None, clock=None, retry_backoff: float = 0.0):
        super().__init__(f"get-headers-{checkpoint:08x}", pool,
                         clock=clock, retry_backoff=retry_backoff)
        self.app = app
        self.archive = archive
        self.checkpoint = checkpoint
        self.out = out

    def on_io(self) -> List[object]:
        blob = self.archive.get_xdr_gz(
            "ledger", H.checkpoint_name(self.checkpoint))
        if blob is None:
            raise RuntimeError(
                f"checkpoint {self.checkpoint:#x} headers missing from "
                f"archive {self.archive.name}")
        from ..xdr.runtime import Reader

        r = Reader(blob)
        entries: List[object] = []
        while not r.done():
            entries.append(T.LedgerHeaderHistoryEntry.unpack(r))
        prev = None
        for e in entries:
            if xdr_sha256(T.LedgerHeader, e.header) != e.hash:
                raise RuntimeError(
                    f"header {e.header.ledgerSeq} hash mismatch in "
                    f"checkpoint {self.checkpoint:#x}")
            if prev is not None and \
                    e.header.previousLedgerHash != prev.hash:
                raise RuntimeError(
                    f"chain break at {e.header.ledgerSeq} inside "
                    f"checkpoint {self.checkpoint:#x}")
            prev = e
        return entries

    def on_complete(self, entries) -> State:
        for e in entries:
            self.out[e.header.ledgerSeq] = e
        self.app.metrics.counter("catchup.chain.verified").inc(len(entries))
        return State.SUCCESS


class DownloadVerifyLedgerChainWork(Work):
    """Fetch the header files covering [first..last] concurrently, then
    back-verify the full hash chain newest-to-oldest, anchoring the
    newest header at the trusted (consensus-attested) hash
    (ref VerifyLedgerChainWork)."""

    def __init__(self, app, archive, first: int, last: int,
                 trusted_hash: Optional[bytes] = None,
                 batch_size: int = 8, clock=None,
                 retry_backoff: float = 0.0):
        super().__init__("verify-ledger-chain",
                         max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.first = first
        self.last = last
        self.trusted_hash = trusted_hash
        self.batch_size = batch_size
        self._clock = clock
        self._retry_backoff = retry_backoff
        self.headers: Dict[int, object] = {}  # seq -> HistoryEntry

    def do_reset(self) -> None:
        self.headers = {}
        hm = self.app.history_manager
        freq = hm.checkpoint_frequency()
        pool = _archive_pool(self.app, self.archive)
        cp = hm.checkpoint_containing(self.first)
        works = []
        while cp - freq < self.last:
            works.append(GetCheckpointHeadersWork(
                self.app, self.archive, cp, self.headers, pool,
                clock=self._clock, retry_backoff=self._retry_backoff))
            cp += freq
        self.add_work(BatchWork("download-headers", iter(works),
                                batch_size=self.batch_size))

    def do_work(self) -> State:
        # per-entry hashes + intra-chunk links were verified on the
        # workers; stitch the chunks: every adjacent pair across the
        # whole range, newest backwards, then the trusted anchor
        with self.app.tracer.span("catchup.verify.chain",
                                  first=self.first, last=self.last):
            prev = None
            for seq in range(self.last, self.first - 1, -1):
                e = self.headers.get(seq)
                if e is None:
                    return State.FAILURE
                if prev is not None and \
                        prev.header.previousLedgerHash != e.hash:
                    return State.FAILURE
                prev = e
            if self.trusted_hash is not None and \
                    self.headers[self.last].hash != self.trusted_hash:
                return State.FAILURE
        return State.SUCCESS


class DownloadBucketWork(ThreadedWork):
    """Fetch one bucket, verify sha256(bytes) == its content address, and
    install it into the node's bucket store (tmp + atomic rename; the
    store is content-addressed so concurrent installs of the same hash
    are idempotent).  Diskless nodes keep the verified bytes in the
    parent's blobs dict instead."""

    def __init__(self, app, archive, hash_hex: str, blobs: Dict[str, bytes],
                 pool=None, clock=None, retry_backoff: float = 0.0):
        super().__init__(f"get-bucket-{hash_hex[:8]}", pool,
                         clock=clock, retry_backoff=retry_backoff)
        self.app = app
        self.archive = archive
        self.hash_hex = hash_hex
        self.blobs = blobs

    def on_io(self):
        bm = self.app.bucket_manager
        if bm.bucket_dir is not None:
            path = bm._bucket_path(self.hash_hex)
            if os.path.exists(path):
                # already in the content-addressed store (verified when
                # opened); nothing to transfer
                return 0, None
        data = self.archive.get_bucket(self.hash_hex)
        if data is None:
            raise RuntimeError(
                f"bucket {self.hash_hex[:16]} missing from archive "
                f"{self.archive.name}")
        if hashlib.sha256(data).hexdigest() != self.hash_hex:
            raise RuntimeError(
                f"bucket {self.hash_hex[:16]} digest mismatch "
                f"(corrupted archive)")
        if bm.bucket_dir is not None:
            tmp = path + f".fetch-{os.getpid()}-{id(self)}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            with bm._gc_lock:
                bm._saved.add(self.hash_hex)
            return len(data), None
        return len(data), data

    def on_complete(self, result) -> State:
        nbytes, data = result
        if data is not None:
            self.blobs[self.hash_hex] = data
        self.app.metrics.counter(
            "catchup.bucket.downloaded-bytes").inc(nbytes)
        return State.SUCCESS


class DownloadBucketsWork(Work):
    """Fetch/verify every bucket the HAS references, bounded-concurrent
    (ref DownloadBucketsWork + VerifyBucketWork)."""

    def __init__(self, app, archive, has, batch_size: int = 8,
                 clock=None, retry_backoff: float = 0.0):
        super().__init__("download-buckets",
                         max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.has = has
        self.batch_size = batch_size
        self._clock = clock
        self._retry_backoff = retry_backoff
        self.blobs: Dict[str, bytes] = {}

    def do_reset(self) -> None:
        self.blobs = {}
        pool = _archive_pool(self.app, self.archive)
        seen = set()
        works = []
        for hh in self.has.all_bucket_hashes():
            if hh == "00" * 32 or hh in seen:
                continue
            seen.add(hh)
            works.append(DownloadBucketWork(
                self.app, self.archive, hh, self.blobs, pool,
                clock=self._clock, retry_backoff=self._retry_backoff))
        self.add_work(BatchWork("download-bucket-files", iter(works),
                                batch_size=self.batch_size))

    def do_work(self) -> State:
        return State.SUCCESS


class GetCheckpointTxsWork(ThreadedWork):
    """Fetch + parse one checkpoint's transaction file into the parent's
    shared seq->TransactionSet dict."""

    def __init__(self, app, archive, checkpoint: int, out: Dict[int, object],
                 pool=None, clock=None, retry_backoff: float = 0.0):
        super().__init__(f"get-txs-{checkpoint:08x}", pool,
                         clock=clock, retry_backoff=retry_backoff)
        self.app = app
        self.archive = archive
        self.checkpoint = checkpoint
        self.out = out

    def on_io(self) -> List[object]:
        blob = self.archive.get_xdr_gz(
            "transactions", H.checkpoint_name(self.checkpoint))
        if blob is None:
            raise RuntimeError(
                f"checkpoint {self.checkpoint:#x} tx sets missing from "
                f"archive {self.archive.name}")
        from ..xdr.runtime import Reader

        r = Reader(blob)
        entries: List[object] = []
        while not r.done():
            entries.append(T.TransactionHistoryEntry.unpack(r))
        return entries

    def on_complete(self, entries) -> State:
        for e in entries:
            self.out[e.ledgerSeq] = e.txSet
        return State.SUCCESS


class DownloadTxSetsWork(Work):
    """Fetch the tx-set files covering [first..last] concurrently
    (ref BatchDownloadWork over HISTORY_FILE_TYPE_TRANSACTIONS)."""

    def __init__(self, app, archive, first: int, last: int,
                 batch_size: int = 8, clock=None,
                 retry_backoff: float = 0.0):
        super().__init__("download-tx-sets",
                         max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.first = first
        self.last = last
        self.batch_size = batch_size
        self._clock = clock
        self._retry_backoff = retry_backoff
        self.tx_sets: Dict[int, object] = {}

    def do_reset(self) -> None:
        self.tx_sets = {}
        hm = self.app.history_manager
        freq = hm.checkpoint_frequency()
        pool = _archive_pool(self.app, self.archive)
        cp = hm.checkpoint_containing(self.first)
        works = []
        while cp - freq < self.last:
            works.append(GetCheckpointTxsWork(
                self.app, self.archive, cp, self.tx_sets, pool,
                clock=self._clock, retry_backoff=self._retry_backoff))
            cp += freq
        self.add_work(BatchWork("download-tx-files", iter(works),
                                batch_size=self.batch_size))

    def do_work(self) -> State:
        return State.SUCCESS


class ApplyBucketsWork(BasicWork):
    """Assume the full ledger state at a checkpoint from its bucket list
    (minimal catchup; ref ApplyBucketsWork + BucketApplicator +
    AssumeStateWork).  Incremental: the 1M-entry live set streams through
    bounded batches across many cranks, so buffered live ledgers keep
    arriving (and other works keep cranking) while state is rebuilt."""

    APPLY_BATCH = 4096          # entries per LedgerTxn flush
    BATCHES_PER_CRANK = 8       # flushes per crank before yielding

    def __init__(self, app, archive, has, header_entry,
                 blobs: Optional[Dict[str, bytes]] = None):
        super().__init__("apply-buckets", max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.has = has
        self.header_entry = header_entry
        self.blobs = blobs or {}
        self._stage = 0
        self._bl: Optional[BucketList] = None
        self._entries = None
        self._root_saved = None
        self.total_bucket_bytes = 0
        self.applied_entries = 0

    def _loader(self, hh: str):
        data = self.blobs.get(hh)
        if data is not None:
            return data
        return self.archive.get_bucket(hh)

    def on_reset(self) -> None:
        self._restore_root()
        self._stage = 0
        self._bl = None
        self._entries = None
        self.total_bucket_bytes = 0
        self.applied_entries = 0

    def _restore_root(self) -> None:
        """Re-attach the ledger root's bucket read source — a root left
        detached would serve every later read from SQL silently."""
        if self._root_saved is None:
            return
        root = self.app.ledger_manager.root
        root._bucket_list, root.bucket_reads_enabled = self._root_saved
        self._root_saved = None

    def on_run(self) -> State:
        try:
            return self._step()
        except RuntimeError:
            self._restore_root()
            return State.FAILURE
        except BaseException:
            self._restore_root()
            raise

    def _step(self) -> State:
        app = self.app
        bm = app.bucket_manager
        header = self.header_entry.header

        if self._stage == 0:
            # restore INTO the node's disk tier: downloaded deep buckets
            # become indexed files (DiskBucket.open verifies each file's
            # digest), shallow ones deserialize + hash-verify in RAM
            level_hashes = [(b["curr"], b["snap"])
                            for b in self.has.buckets]
            self._bl = BucketList.restore(
                level_hashes, self._loader,
                disk_dir=bm.bucket_dir,
                disk_level=getattr(app.config, "DISK_BUCKET_LEVEL", None))
            self._stage = 1
            return State.RUNNING

        if self._stage == 1:
            # the restored list must reproduce the VERIFIED header's
            # bucketListHash — this is the bit that makes bucket-apply
            # as trustworthy as replay
            if self._bl.hash() != header.bucketListHash:
                raise RuntimeError("restored bucket list does not match "
                                   "the verified header's bucketListHash")
            total = 0
            for lv in self._bl.levels:
                for b in (lv.curr, lv.snap):
                    if b.is_empty():
                        continue
                    path = getattr(b, "path", None)
                    if path is not None and os.path.exists(path):
                        total += os.path.getsize(path)
                    else:
                        total += len(b.serialize())
            self.total_bucket_bytes = total
            self._stage = 2
            return State.RUNNING

        if self._stage == 2:
            # wipe + rebuild the SQL entry store from the live bucket
            # entries.  Overlay capture must be off for the duration or a
            # 1M-entry catchup pins every decoded entry in the sql-ahead
            # dict at once (the assumed bucket list is authoritative)
            db = app.database
            db.execute("DELETE FROM ledgerentries")
            db.execute("DELETE FROM offers")
            db.execute("DELETE FROM ledgerheaders")
            db.commit()
            root = app.ledger_manager.root
            root.clear_entry_cache()
            self._root_saved = (root._bucket_list,
                                root.bucket_reads_enabled)
            root._bucket_list = None
            root.bucket_reads_enabled = False
            with LedgerTxn(root) as ltx:
                ltx.set_header(header)
                ltx.commit()
            root._header_cache = None
            self._entries = self._bl.iter_live_entries()
            self._stage = 3
            return State.RUNNING

        if self._stage == 3:
            # stream the live set (bounded memory: deep levels may be
            # disk buckets far larger than RAM) in BucketApplicator-style
            # chunks, a few per crank
            root = app.ledger_manager.root
            for _ in range(self.BATCHES_PER_CRANK):
                batch: list = []
                for kb, entry in self._entries:
                    batch.append(entry)
                    if len(batch) >= self.APPLY_BATCH:
                        break
                if batch:
                    app.invariants.check_on_bucket_apply(batch, header)
                    with LedgerTxn(root) as ltx:
                        for e in batch:
                            ltx.put(e)
                        ltx.commit()
                    self.applied_entries += len(batch)
                    app.metrics.counter(
                        "catchup.bucket.applied-entries").inc(len(batch))
                if len(batch) < self.APPLY_BATCH:
                    self._entries = None
                    self._stage = 4
                    return State.RUNNING
            return State.RUNNING

        # stage 4: finalize — re-attach reads, adopt the bucket list,
        # stamp the LCL + persisted restart state
        self._restore_root()
        root = app.ledger_manager.root
        bm.assume_bucket_list(self._bl)
        if app.config.BUCKETLIST_DB:
            bm.bucket_list.ensure_indexes()
        root.clear_entry_cache()
        app.ledger_manager._lcl_hash = self.header_entry.hash
        app.ledger_manager._store_lcl(header)
        # keep the persisted restart state in step with the assumed
        # bucket list — a restart before the next close would otherwise
        # restore the pre-catchup level hashes and refuse to boot
        app.ledger_manager._store_bucket_state()
        app.metrics.counter(
            "catchup.bucket.applied-bytes").inc(self.total_bucket_bytes)
        return State.SUCCESS

    def on_abort(self) -> bool:
        self._restore_root()
        return True


class ApplyCheckpointsWork(BasicWork):
    """Replay archived tx sets through the normal closeLedger path,
    verifying every resulting header hash against the verified chain
    (complete catchup / the replay tail; ref ApplyCheckpointWork +
    ApplyLedgerWork).  Tx sets are pre-downloaded (DownloadTxSetsWork)
    when driven by CatchupWork; direct users fall back to a synchronous
    load."""

    def __init__(self, app, archive, headers: Dict[int, object],
                 first: int, last: int,
                 tx_sets: Optional[Dict[int, object]] = None):
        super().__init__("apply-checkpoints",
                         max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.headers = headers
        self.first = first
        self.last = last
        self._prefetched = tx_sets is not None
        self._tx_sets = dict(tx_sets) if tx_sets is not None else {}
        self._loaded_cps: set = set()
        self._next = first

    def _ensure_checkpoint(self, seq: int) -> bool:
        """Lazily load the tx-set chunk covering ``seq`` — one checkpoint
        at a time, so replaying a long range never holds the whole
        history's decoded transactions in memory at once."""
        hm = self.app.history_manager
        cp = hm.checkpoint_containing(seq)
        if cp in self._loaded_cps:
            return True
        blob = self.archive.get_xdr_gz("transactions",
                                       H.checkpoint_name(cp))
        if blob is None:
            return False
        from ..xdr.runtime import Reader

        r = Reader(blob)
        while not r.done():
            e = T.TransactionHistoryEntry.unpack(r)
            self._tx_sets[e.ledgerSeq] = e.txSet
        self._loaded_cps.add(cp)
        return True

    def on_run(self) -> State:
        from ..herder.tx_set import TxSetFrame
        from ..ledger.ledger_manager import LedgerCloseData

        app = self.app
        seq = self._next
        if seq > self.last:
            return State.SUCCESS
        entry = self.headers.get(seq)
        if entry is None:
            return State.FAILURE
        if not self._prefetched and not self._ensure_checkpoint(seq):
            return State.FAILURE
        hdr = entry.header
        # pop: an applied ledger's decoded transactions are never needed
        # again — keeps replay memory bounded by one checkpoint chunk
        xdr_set = self._tx_sets.pop(seq, None)
        if xdr_set is None:
            xdr_set = T.TransactionSet.make(
                previousLedgerHash=hdr.previousLedgerHash, txs=[])
        frame = TxSetFrame.make_from_wire(app.config.network_id(), xdr_set)
        # replayed closes must not re-publish checkpoints: this node has
        # no scp history for them, and writing would clobber the very
        # archive files being read
        with app.history_manager.publish_suppressed():
            app.ledger_manager.close_ledger(
                LedgerCloseData(seq, frame, hdr.scpValue))
        if app.ledger_manager.last_closed_hash() != entry.hash:
            return State.FAILURE  # replay divergence — fail loudly
        app.metrics.counter("catchup.ledger.replayed").inc()
        self._next += 1
        return State.RUNNING


class CatchupWork(Work):
    """The top-level DAG (ref CatchupWork.h:44): HAS -> {verified header
    chain ∥ bucket files ∥ tail tx sets} downloaded concurrently ->
    buckets applied at the anchor checkpoint (minimal) or full replay
    from the local LCL (complete) -> the post-checkpoint tail replayed.
    Phase wall-times land in catchup.phase.{verify,apply,replay} timers
    (verify = HAS + all downloads + chain verification)."""

    STAGE_HAS = 0
    STAGE_DOWNLOAD = 1
    STAGE_APPLY = 2
    STAGE_REPLAY = 3
    STAGE_DONE = 4

    # longest replay tail whose tx sets are prefetched in parallel;
    # longer ranges stream one checkpoint chunk at a time (memory)
    PREFETCH_MAX_LEDGERS = 128

    _PHASE_NAME = {STAGE_HAS: "verify", STAGE_DOWNLOAD: "verify",
                   STAGE_APPLY: "apply", STAGE_REPLAY: "replay"}

    def __init__(self, app, archive, config: CatchupConfiguration,
                 trusted_hash: Optional[bytes] = None,
                 retry_backoff: float = 0.0):
        super().__init__("catchup", max_retries=BasicWork.RETRY_NEVER)
        self.app = app
        self.archive = archive
        self.config = config
        self.trusted_hash = trusted_hash
        self.retry_backoff = retry_backoff
        hm = app.history_manager
        self.target_checkpoint = hm.latest_checkpoint_at_or_before(
            config.to_ledger)
        self.get_has: Optional[GetHistoryArchiveStateWork] = None
        self.verify: Optional[DownloadVerifyLedgerChainWork] = None
        self.buckets_dl: Optional[DownloadBucketsWork] = None
        self.txs_dl: Optional[DownloadTxSetsWork] = None
        self._stage = self.STAGE_HAS
        self._phase_t0: Optional[float] = None
        self._use_buckets = False
        self._first_needed = 0

    @property
    def phase(self) -> str:
        if self.done:
            return self.state.name.lower()
        return self._PHASE_NAME.get(self._stage, "idle")

    def _end_phase(self, next_stage: int) -> None:
        # wall-clock phase attribution is metrics-only (never feeds a
        # consensus hash); under VIRTUAL_TIME it still reflects the real
        # cost of downloads/apply, which is what the bench splits on
        # detlint: allow(det-wallclock) metrics-only phase timing
        now = time.monotonic()
        if self._phase_t0 is not None:
            name = self._PHASE_NAME.get(self._stage)
            if name is not None and next_stage != self._stage and \
                    self._PHASE_NAME.get(next_stage) != name:
                self.app.metrics.timer(f"catchup.phase.{name}").update(
                    now - self._phase_t0)
                self._phase_t0 = now
        else:
            self._phase_t0 = now
        self._stage = next_stage

    def do_reset(self) -> None:
        app = self.app
        hm = app.history_manager
        lcl = app.ledger_manager.last_closed_seq()
        # detlint: allow(det-wallclock) metrics-only phase timing
        self._phase_t0 = time.monotonic()
        self._stage = self.STAGE_HAS
        self._use_buckets = (
            self.config.mode == CatchupConfiguration.MINIMAL
            and self.target_checkpoint > lcl)
        if self._use_buckets:
            self._first_needed = max(
                hm.first_ledger_in_checkpoint(self.target_checkpoint) - 1,
                1)
            self.get_has = GetHistoryArchiveStateWork(
                app, self.archive, self.target_checkpoint,
                clock=app.clock, retry_backoff=self.retry_backoff)
            self.add_work(self.get_has)
        else:
            self._first_needed = lcl + 1
            self.get_has = None

    def do_work(self) -> State:
        app = self.app
        clock = app.clock
        if self._stage == self.STAGE_HAS:
            self.verify = DownloadVerifyLedgerChainWork(
                app, self.archive, self._first_needed,
                self.config.to_ledger, self.trusted_hash,
                clock=clock, retry_backoff=self.retry_backoff)
            self.add_work(self.verify)
            if self._use_buckets:
                self.buckets_dl = DownloadBucketsWork(
                    app, self.archive, self.get_has.has,
                    clock=clock, retry_backoff=self.retry_backoff)
                self.add_work(self.buckets_dl)
                replay_first = self.target_checkpoint + 1
            else:
                replay_first = self._first_needed
            # parallel tx-set prefetch only pays off for short tails; a
            # long complete-mode replay would hold every decoded tx in
            # memory at once — beyond the cap, ApplyCheckpointsWork
            # streams chunks lazily instead
            if (replay_first <= self.config.to_ledger and
                    self.config.to_ledger - replay_first + 1
                    <= self.PREFETCH_MAX_LEDGERS):
                self.txs_dl = DownloadTxSetsWork(
                    app, self.archive, replay_first, self.config.to_ledger,
                    clock=clock, retry_backoff=self.retry_backoff)
                self.add_work(self.txs_dl)
            self._end_phase(self.STAGE_DOWNLOAD)
            return State.RUNNING

        if self._stage == self.STAGE_DOWNLOAD:
            if self._use_buckets:
                entry = self.verify.headers[self.target_checkpoint]
                self.add_work(ApplyBucketsWork(
                    app, self.archive, self.get_has.has, entry,
                    blobs=self.buckets_dl.blobs))
                self._end_phase(self.STAGE_APPLY)
                return State.RUNNING
            self._end_phase(self.STAGE_APPLY)
            # fall through to schedule the replay

        if self._stage == self.STAGE_APPLY:
            replay_first = (self.target_checkpoint + 1 if self._use_buckets
                            else self._first_needed)
            if replay_first <= self.config.to_ledger:
                self.add_work(ApplyCheckpointsWork(
                    app, self.archive, self.verify.headers,
                    replay_first, self.config.to_ledger,
                    tx_sets=(self.txs_dl.tx_sets if self.txs_dl
                             else None)))
                self._end_phase(self.STAGE_REPLAY)
                return State.RUNNING
            self._end_phase(self.STAGE_REPLAY)

        self._end_phase(self.STAGE_DONE)
        return State.SUCCESS
