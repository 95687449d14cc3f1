"""HistoryManager: checkpoint cadence + publishing snapshots to archives
(ref src/history/HistoryManagerImpl.cpp; StateSnapshot.cpp;
src/historywork/PublishWork and friends).

Checkpoints close every 64 ledgers (8 under accelerated-time testing, ref
getCheckpointFrequency :86-96).  A checkpoint covering ledgers
[first..last] publishes: the header chain, per-ledger tx sets, result
sets, SCP messages, the bucket files referenced by the current bucket
list, and the HAS json.  Publishing runs as Work items on the app's
WorkScheduler (the Work system's first consumer)."""
from __future__ import annotations

import threading
from typing import List, Optional

from ..utils.lockdep import register_lock
from ..work.work import BasicWork, State
from ..xdr import types as T
from ..xdr import xdr_sha256
from .archive import HistoryArchive, HistoryArchiveState, checkpoint_name


class HistoryManager:
    def __init__(self, app):
        self.app = app
        self.archives: List[HistoryArchive] = []
        for spec in getattr(app.config, "HISTORY_ARCHIVES", []):
            if isinstance(spec, dict):
                from .archive import CommandArchive

                self.archives.append(CommandArchive(
                    spec["name"], get_cmd=spec.get("get"),
                    put_cmd=spec.get("put"),
                    mkdir_cmd=spec.get("mkdir"),
                    process_manager=app.process_manager))
            else:
                name, path = spec
                self.archives.append(HistoryArchive(name, path))
        self.published_checkpoints = 0
        # replay (catchup) closes must not re-publish into the archive
        # being read — see ApplyCheckpointsWork.  Scoped + depth-counted:
        # only publish_suppressed() can set it, so an exception mid-
        # replay can never leave a node that silently never publishes
        # again (the old bare-flag failure mode)
        self._suppress_publish_depth = 0
        # buckets referenced by queued-but-unpublished checkpoints.
        # Written from whichever thread runs the close path (main in
        # sequential mode, the close tail in pipelined mode — detlint
        # conc-unguarded-shared); reads (_bucket_bytes) stay lock-free:
        # dict get/snapshot is GIL-atomic and a stale read only re-reads
        # the bucket from the live list or disk
        self._pin_lock = register_lock(threading.Lock(), "history.pin")
        self._pinned = {}  # guarded-by: _pin_lock

    @property
    def suppress_publish(self) -> bool:
        return self._suppress_publish_depth > 0

    def publish_suppressed(self):
        """Exception-safe scope in which checkpoint publishing is off
        (replay/catchup closes).  Reentrant: nested scopes stack."""
        import contextlib

        @contextlib.contextmanager
        def _guard():
            self._suppress_publish_depth += 1
            try:
                yield
            finally:
                self._suppress_publish_depth -= 1

        return _guard()

    # -- crash-safe publish queue (persistentstate row; ref the reference
    # persisting its publish queue inside the ledger-commit txn,
    # LedgerManagerImpl.cpp:877-881) -----------------------------------------

    def _load_queue(self) -> List[int]:
        import json

        row = self.app.database.execute(
            "SELECT state FROM persistentstate WHERE "
            "statename='publishqueue'").fetchone()
        return json.loads(row[0]) if row else []

    def _store_queue(self, queue: List[int]) -> None:
        import json

        self.app.database.execute(
            "INSERT INTO persistentstate(statename, state) "
            "VALUES('publishqueue', ?) ON CONFLICT(statename) "
            "DO UPDATE SET state=excluded.state", (json.dumps(queue),))
        self.app.database.commit()

    # -- cadence (ref getCheckpointFrequency) -------------------------------

    def checkpoint_frequency(self) -> int:
        if self.app.config.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING:
            return 8
        return 64

    def is_last_ledger_in_checkpoint(self, seq: int) -> bool:
        return (seq + 1) % self.checkpoint_frequency() == 0

    def checkpoint_containing(self, seq: int) -> int:
        """The checkpoint ledger (last seq) whose range contains seq."""
        f = self.checkpoint_frequency()
        return ((seq // f) + 1) * f - 1

    def first_ledger_in_checkpoint(self, checkpoint: int) -> int:
        f = self.checkpoint_frequency()
        first = checkpoint - f + 1
        return max(first, 1)

    def latest_checkpoint_at_or_before(self, seq: int) -> int:
        f = self.checkpoint_frequency()
        c = self.checkpoint_containing(seq)
        return c if c <= seq else c - f

    # -- close-path hooks (ref maybeQueueHistoryCheckpoint /
    # publishQueuedHistory, called from closeLedger) -------------------------

    def maybe_queue_history_checkpoint(self, seq: int, level_hashes=None,
                                       buckets=None) -> None:
        """Queue entries snapshot the bucket-list level hashes AT the
        checkpoint ledger — a crash-delayed republish must not stamp the
        HAS with whatever the bucket list looks like later (the archived
        header's bucketListHash would never match and minimal catchup to
        that checkpoint would be permanently broken).  The referenced
        buckets are pinned in memory until published (ref
        PublishQueueBuckets retaining files via refcounts).

        The pipelined close tail passes ``level_hashes``/``buckets``
        snapshots captured at seal: by the time the tail runs, the NEXT
        close may already be mutating the live level list."""
        if not self.archives or self.suppress_publish:
            return
        if self.is_last_ledger_in_checkpoint(seq):
            q = self._load_queue()
            if not any(e[0] == seq for e in q):
                if level_hashes is None:
                    level_hashes = \
                        self.app.bucket_manager.bucket_list.level_hashes()
                q.append([seq, level_hashes])
                self._store_queue(q)
                if buckets is None:
                    buckets = [
                        b for lv in
                        self.app.bucket_manager.bucket_list.levels
                        for b in (lv.curr, lv.snap) if not b.is_empty()]
                with self._pin_lock:
                    for b in buckets:
                        self._pinned[b.hash().hex()] = b

    def publish_queued_history(self) -> None:
        """Run a PublishWork per queued checkpoint.  The queue is a
        persistentstate row, so a crash between queueing and publishing
        re-publishes on restart.  Local-directory archives publish in one
        crank; the loop bound covers retries (a remote transport would
        leave the work pending on the scheduler instead of draining
        here)."""
        from ..work.work import State

        if self.suppress_publish:
            return
        queue = self._load_queue()
        remaining = list(queue)
        for entry in queue:
            seq, level_hashes = entry[0], entry[1]
            w = PublishWork(self.app, seq, level_hashes)
            # crank the work directly: publishing can run from inside a
            # ledger close, and cranking the app-wide scheduler here would
            # re-enter whatever work (e.g. a CatchupWork) triggered that
            # close
            w.start()
            for _ in range(100):
                w.crank()
                if w.state not in (State.RUNNING, State.WAITING):
                    break
            if w.state == State.SUCCESS:
                remaining.remove(entry)
                self.app.metrics.counter("history.publish.success").inc()
            else:
                self.app.metrics.counter("history.publish.failure").inc()
        if remaining != queue:
            self._store_queue(remaining)
        # unpin buckets no longer referenced by any queued checkpoint
        still = {hh for e in remaining for pair in e[1] for hh in pair}
        with self._pin_lock:
            for hh in list(self._pinned):
                if hh not in still:
                    del self._pinned[hh]

    # -- snapshot construction (ref StateSnapshot) --------------------------

    def _bucket_bytes(self, hh: str):
        """Serialized bucket for a hash: pinned publish snapshot, the live
        bucket list, or the on-disk store — None if unavailable."""
        b = self._pinned.get(hh)
        if b is not None:
            return b.serialize()
        for lv in self.app.bucket_manager.bucket_list.levels:
            for cand in (lv.curr, lv.snap):
                if cand.hash().hex() == hh:
                    return cand.serialize()
        return self.app.bucket_manager.load_bucket_bytes(hh)

    def write_snapshot(self, checkpoint: int,
                       level_hashes=None) -> None:
        """Write one checkpoint's files to every configured archive.
        level_hashes: the bucket-list state AT the checkpoint (snapshotted
        at queue time); defaults to the current state for direct calls."""
        app = self.app
        first = self.first_ledger_in_checkpoint(checkpoint)
        name = checkpoint_name(checkpoint)
        if level_hashes is None:
            level_hashes = app.bucket_manager.bucket_list.level_hashes()

        headers = []
        for seq in range(first, checkpoint + 1):
            row = app.database.execute(
                "SELECT data FROM ledgerheaders WHERE ledgerseq=?",
                (seq,)).fetchone()
            if row is None:
                raise RuntimeError(f"missing header {seq} for publish")
            hdr = T.LedgerHeader.decode(row[0])
            headers.append(T.LedgerHeaderHistoryEntry.make(
                hash=xdr_sha256(T.LedgerHeader, hdr), header=hdr,
                ext=T.LedgerHeaderHistoryEntry.fields[2][1].make(0)))
        ledger_blob = b"".join(
            T.LedgerHeaderHistoryEntry.encode(h) for h in headers)

        tx_blob_parts = []
        res_blob_parts = []
        for i, seq in enumerate(range(first, checkpoint + 1)):
            rows = app.database.execute(
                "SELECT txbody, txresult FROM txhistory WHERE ledgerseq=? "
                "ORDER BY txindex", (seq,)).fetchall()
            if not rows:
                continue
            prev_hash = headers[i].header.previousLedgerHash
            txs = [T.TransactionEnvelope.decode(r[0]) for r in rows]
            tx_blob_parts.append(T.TransactionHistoryEntry.encode(
                T.TransactionHistoryEntry.make(
                    ledgerSeq=seq,
                    txSet=T.TransactionSet.make(
                        previousLedgerHash=prev_hash, txs=txs),
                    ext=T.TransactionHistoryEntry.fields[2][1].make(0))))
            results = [T.TransactionResultPair.decode(r[1]) for r in rows]
            res_blob_parts.append(T.TransactionHistoryResultEntry.encode(
                T.TransactionHistoryResultEntry.make(
                    ledgerSeq=seq,
                    txResultSet=T.TransactionResultSet.make(
                        results=results),
                    ext=T.TransactionHistoryResultEntry.fields[2][1]
                    .make(0))))

        scp_parts = []
        for seq in range(first, checkpoint + 1):
            rows = app.database.execute(
                "SELECT envelope FROM scphistory WHERE ledgerseq=? ",
                (seq,)).fetchall()
            for (raw,) in rows:
                scp_parts.append(raw)

        has = HistoryArchiveState(
            checkpoint,
            [{"curr": c, "snap": s} for c, s in level_hashes],
            app.config.NETWORK_PASSPHRASE)

        bucket_blobs = {}
        for pair in level_hashes:
            for hh in pair:
                if hh == "00" * 32 or hh in bucket_blobs:
                    continue
                # content-addressed: a bucket every archive already holds
                # never needs re-serializing (lower levels are stable
                # across hundreds of checkpoints; at the 1M-entry tier
                # re-reading them each publish dominates the close path)
                if all(a.has_bucket(hh) for a in self.archives):
                    continue
                data = self._bucket_bytes(hh)
                if data is None:
                    raise RuntimeError(
                        f"bucket {hh} for checkpoint {checkpoint} is no "
                        f"longer available; publish stays queued")
                bucket_blobs[hh] = data

        for archive in self.archives:
            archive.put_xdr_gz("ledger", name, ledger_blob)
            archive.put_xdr_gz("transactions", name,
                               b"".join(tx_blob_parts))
            archive.put_xdr_gz("results", name, b"".join(res_blob_parts))
            archive.put_xdr_gz("scp", name, b"".join(scp_parts))
            for hh, data in sorted(bucket_blobs.items()):
                archive.put_bucket(hh, data)
            archive.put_has(has)
        self.published_checkpoints += 1


class PublishWork(BasicWork):
    """One checkpoint's publish as a Work item (ref
    src/historywork/PublishWork.h — collapsed to a single step since the
    archive is a local directory; remote transports would expand this to
    the reference's per-file work sequence)."""

    def __init__(self, app, checkpoint: int, level_hashes=None):
        super().__init__(f"publish-{checkpoint:08x}",
                         max_retries=BasicWork.RETRY_A_FEW)
        self.app = app
        self.checkpoint = checkpoint
        self.level_hashes = level_hashes

    def on_run(self) -> State:
        try:
            self.app.history_manager.write_snapshot(
                self.checkpoint, self.level_hashes)
            return State.SUCCESS
        except Exception:
            return State.FAILURE
