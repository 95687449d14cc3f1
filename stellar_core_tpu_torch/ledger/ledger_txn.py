"""LedgerTxn: nested in-memory transaction layers over ledger entries with
commit/rollback; the root commits to SQLite.

Design (re-derived from the reference's 70-line design essay at
src/ledger/LedgerTxn.h:22-100, simplified to a functional copy-on-write
model instead of the reference's entry-activation machinery):

- Keys are canonical XDR-encoded ``LedgerKey`` bytes.
- A layer holds a delta: key -> LedgerEntry-value | None (None = erased).
- Reads fall through to the parent; writes stay in the layer until commit.
- ``changes()`` produces LedgerEntryChanges (STATE+UPDATED/CREATED/REMOVED)
  for meta streams, matching the reference's semantics of emitting the
  previous STATE before each change (ref LedgerTxn::getChanges).
- At most one open child per layer (enforced, like the reference).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.tracing import stopwatch
from ..xdr import types as T
from .packed import entry_type_from_key


class LedgerTxnError(Exception):
    pass


# -- virtual (never-committed) entries ---------------------------------------
# The reference tracks active sponsorships as *internal* ledger entries that
# live only inside LedgerTxn layers (ref src/ledger/InternalLedgerEntry.h:16-17,
# SPONSORSHIP / SPONSORSHIP_COUNTER) so they roll back with the op/tx that
# created them and must all be gone by commit time.  Virtual keys use a \xff
# prefix, which can never collide with an XDR-encoded LedgerKey (those start
# with a \x00 byte of the 4-byte big-endian type discriminant).

VIRTUAL_PREFIX = b"\xff"

_CACHE_MISS = object()  # sentinel: None is a valid (negative) cache value


def account_key(account_id: bytes):
    """LedgerKey for an account (the one place the key layout lives)."""
    return T.LedgerKey.make(
        T.LedgerEntryType.ACCOUNT,
        T.LedgerKey.arms[T.LedgerEntryType.ACCOUNT][1].make(
            accountID=T.account_id(account_id)))


def trustline_key(account_id: bytes, asset):
    """LedgerKey for a trustline; asset is a TrustLineAsset."""
    return T.LedgerKey.make(
        T.LedgerEntryType.TRUSTLINE,
        T.LedgerKey.arms[T.LedgerEntryType.TRUSTLINE][1].make(
            accountID=T.account_id(account_id), asset=asset))


def sponsorship_key(sponsored_id: bytes) -> bytes:
    return b"\xffSP" + sponsored_id


def sponsorship_counter_key(sponsoring_id: bytes) -> bytes:
    return b"\xffSC" + sponsoring_id


def entry_to_key(entry) -> object:
    """LedgerEntry -> LedgerKey value."""
    d = entry.data
    t = d.type
    LE = T.LedgerEntryType
    if t == LE.ACCOUNT:
        arm = T.LedgerKey.arms[t][1].make(accountID=d.value.accountID)
    elif t == LE.TRUSTLINE:
        arm = T.LedgerKey.arms[t][1].make(
            accountID=d.value.accountID, asset=d.value.asset)
    elif t == LE.OFFER:
        arm = T.LedgerKey.arms[t][1].make(
            sellerID=d.value.sellerID, offerID=d.value.offerID)
    elif t == LE.DATA:
        arm = T.LedgerKey.arms[t][1].make(
            accountID=d.value.accountID, dataName=d.value.dataName)
    elif t == LE.CLAIMABLE_BALANCE:
        arm = T.LedgerKey.arms[t][1].make(balanceID=d.value.balanceID)
    elif t == LE.LIQUIDITY_POOL:
        arm = T.LedgerKey.arms[t][1].make(
            liquidityPoolID=d.value.liquidityPoolID)
    else:
        raise LedgerTxnError(f"unknown entry type {t}")
    return T.LedgerKey.make(t, arm)


def key_bytes(key) -> bytes:
    return T.LedgerKey.encode(key)


# account LedgerKey encodings are the hottest key path (every fee / seqnum /
# signature check loads the source account); cache them by raw account id
_ACCOUNT_KB: Dict[bytes, bytes] = {}


def account_key_bytes(account_id: bytes) -> bytes:
    kb = _ACCOUNT_KB.get(account_id)
    if kb is None:
        if len(_ACCOUNT_KB) >= 1 << 16:
            _ACCOUNT_KB.clear()
        kb = key_bytes(account_key(account_id))
        _ACCOUNT_KB[account_id] = kb
    return kb


class AbstractLedgerTxn:
    """Shared read/write surface of LedgerTxn and LedgerTxnRoot."""

    def get(self, kb: bytes):
        raise NotImplementedError

    def header(self):
        raise NotImplementedError

    # -- typed convenience loads (the TransactionUtils seam) ---------------

    def load(self, key) -> Optional[object]:
        return self.get(key_bytes(key))

    def load_account(self, account_id: bytes):
        return self.get(account_key_bytes(account_id))

    def load_trustline(self, account_id: bytes, asset):
        return self.load(trustline_key(account_id, asset))

    def load_offer(self, seller_id: bytes, offer_id: int):
        k = T.LedgerKey.make(
            T.LedgerEntryType.OFFER,
            T.LedgerKey.arms[T.LedgerEntryType.OFFER][1].make(
                sellerID=T.account_id(seller_id), offerID=offer_id))
        return self.load(k)

    def load_data(self, account_id: bytes, name: bytes):
        k = T.LedgerKey.make(
            T.LedgerEntryType.DATA,
            T.LedgerKey.arms[T.LedgerEntryType.DATA][1].make(
                accountID=T.account_id(account_id), dataName=name))
        return self.load(k)


# instance-confined: a LedgerTxn is built, filled, and committed by ONE
# thread at a time (main seals it, the pipelined tail commits the staged
# root state; hand-off happens-before via ClosePipeline._lock), so its
# fields need no per-field lock
class LedgerTxn(AbstractLedgerTxn):  # detlint: allow(conc-unguarded-shared)
    def __init__(self, parent: AbstractLedgerTxn):
        self.parent = parent
        if isinstance(parent, (LedgerTxn, LedgerTxnRoot)):
            if parent._child is not None:
                raise LedgerTxnError("parent already has an open child")
            parent._child = self
        self._delta: Dict[bytes, Optional[object]] = {}
        self._vkeys: set = set()  # virtual (\xff) keys present in _delta
        self._okeys: set = set()  # offer keys present in _delta
        self._header = None  # modified header, if any
        self._child: Optional["LedgerTxn"] = None
        self._open = True

    # -- reads -------------------------------------------------------------

    def _check_open(self):
        """Write/commit guard: must be open AND innermost (no open child).
        Reads only require being open — a child's fall-through read reaches
        the parent while the child is the parent's open child."""
        if not self._open:
            raise LedgerTxnError("ledger txn is closed")
        if self._child is not None:
            raise LedgerTxnError("ledger txn has an open child")

    def get(self, kb: bytes):
        if not self._open:
            raise LedgerTxnError("ledger txn is closed")
        if kb in self._delta:
            return self._delta[kb]
        return self.parent.get(kb)

    def header(self):
        if not self._open:
            raise LedgerTxnError("ledger txn is closed")
        if self._header is not None:
            return self._header
        return self.parent.header()

    def set_header(self, header) -> None:
        self._check_open()
        self._header = header

    # -- writes ------------------------------------------------------------

    def put(self, entry) -> None:
        """Create or update; stamps lastModifiedLedgerSeq with the current
        (open) ledger seq like the reference does on commit."""
        self._check_open()
        entry = entry._replace(
            lastModifiedLedgerSeq=self.header().ledgerSeq)
        kb = key_bytes(entry_to_key(entry))
        self._delta[kb] = entry
        if kb.startswith(_OFFER_PREFIX):
            self._okeys.add(kb)

    def erase(self, key) -> None:
        self._check_open()
        kb = key_bytes(key)
        if self.get(kb) is None:
            raise LedgerTxnError("erasing nonexistent entry")
        self._delta[kb] = None
        if kb.startswith(_OFFER_PREFIX):
            self._okeys.add(kb)

    # -- virtual entries (sponsorship bookkeeping; see module header) -------

    def put_virtual(self, kb: bytes, value) -> None:
        self._check_open()
        assert kb.startswith(VIRTUAL_PREFIX)
        self._delta[kb] = value
        self._vkeys.add(kb)

    def erase_virtual(self, kb: bytes) -> None:
        self._check_open()
        assert kb.startswith(VIRTUAL_PREFIX)
        self._delta[kb] = None
        self._vkeys.add(kb)

    def live_virtual_keys(self, prefix: bytes) -> List[bytes]:
        """Virtual keys with a live (non-erased) value visible from this
        layer, walking the parent chain (root never has any).  Each layer
        indexes its virtual keys (``_vkeys``) so this never scans the
        ordinary entry delta — unindexed it was O(total delta) per call,
        quadratic over a big close."""
        self._check_open()
        seen: Dict[bytes, Optional[object]] = {}
        layer = self
        while isinstance(layer, LedgerTxn):
            for kb in layer._vkeys:
                if kb.startswith(prefix) and kb not in seen:
                    seen[kb] = layer._delta[kb]
            layer = layer.parent
        return [kb for kb, v in seen.items() if v is not None]

    # -- lifecycle ---------------------------------------------------------

    def commit(self) -> None:
        self._check_open()
        if isinstance(self.parent, LedgerTxnRoot):
            self.parent._commit_from_child(self._delta, self._header)
        else:
            self.parent._delta.update(self._delta)
            self.parent._vkeys |= self._vkeys
            self.parent._okeys |= self._okeys
            if self._header is not None:
                self.parent._header = self._header
        self._close()

    def rollback(self) -> None:
        if not self._open:
            raise LedgerTxnError("ledger txn is closed")
        if self._child is not None:
            self._child.rollback()
        self._close()

    def _close(self) -> None:
        self._open = False
        if isinstance(self.parent, (LedgerTxn, LedgerTxnRoot)):
            self.parent._child = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._open:
            if exc_type is None:
                self.commit()
            else:
                self.rollback()
        return False

    # -- meta --------------------------------------------------------------

    def changes(self) -> List[object]:
        """LedgerEntryChanges for the delta of THIS layer: STATE (previous
        value from the parent) + UPDATED / CREATED / REMOVED."""
        self._check_open()
        out = []
        CT = T.LedgerEntryChangeType
        for kb, new in sorted(self._delta.items()):
            if kb.startswith(VIRTUAL_PREFIX):
                continue  # sponsorship bookkeeping never reaches meta
            old = self.parent.get(kb)
            if old is not None:
                out.append(T.LedgerEntryChange.make(
                    CT.LEDGER_ENTRY_STATE, old))
                if new is None:
                    out.append(T.LedgerEntryChange.make(
                        CT.LEDGER_ENTRY_REMOVED, T.LedgerKey.decode(kb)))
                else:
                    out.append(T.LedgerEntryChange.make(
                        CT.LEDGER_ENTRY_UPDATED, new))
            else:
                if new is None:
                    continue  # created+erased inside this layer: no-op
                out.append(T.LedgerEntryChange.make(
                    CT.LEDGER_ENTRY_CREATED, new))
        return out

    # -- queries needing parent cooperation --------------------------------

    def best_offer(self, selling_bytes: bytes, buying_bytes: bytes,
                   worse_than=None):
        """Best (lowest price, then oldest) offer for the asset pair,
        taking this txn's uncommitted delta into account.

        selling/buying are canonical XDR Asset encodings."""
        self._check_open()
        overrides, root = self._collect_offer_overrides()
        return root._best_offer(
            selling_bytes, buying_bytes, overrides, worse_than)

    def _collect_offer_overrides(self):
        return self._collect_overrides(_OFFER_PREFIX)

    def _collect_overrides(self, prefix: bytes):
        """Uncommitted delta entries (and deletions) with the given key
        prefix up the layer chain, nearest layer winning, plus the root.
        Offer keys ride the per-layer ``_okeys`` index — the unindexed
        scan was O(total delta) per best_offer call, quadratic over a
        DEX-heavy close."""
        overrides: Dict[bytes, Optional[object]] = {}
        layer = self
        if prefix == _OFFER_PREFIX:
            while isinstance(layer, LedgerTxn):
                for kb in layer._okeys:
                    if kb not in overrides:
                        overrides[kb] = layer._delta[kb]
                layer = layer.parent
            return overrides, layer
        while isinstance(layer, LedgerTxn):
            for kb, e in layer._delta.items():
                if kb not in overrides and kb.startswith(prefix):
                    overrides[kb] = e
            layer = layer.parent
        return overrides, layer

    def offers_by_account(self, account_id: bytes):
        """All live offers owned by ``account_id``, delta-aware (ref
        loadOffersByAccountAndAsset, LedgerTxn.cpp — asset filtering is
        the caller's job)."""
        self._check_open()
        overrides, root = self._collect_offer_overrides()
        out = []
        for kb, e in root._offers_by_seller(account_id):
            if kb in overrides:
                continue
            out.append(e)
        for kb, e in overrides.items():
            if e is not None and \
                    e.data.value.sellerID.value == account_id:
                out.append(e)
        return out

    def entries_by_key_prefix(self, prefix: bytes):
        """All live entries whose encoded LedgerKey starts with ``prefix``,
        delta-aware (used for by-account scans: trustlines of an account
        share the type+accountID key prefix)."""
        self._check_open()
        overrides, root = self._collect_overrides(prefix)
        out = []
        for kb, e in root._entries_by_key_prefix(prefix):
            if kb not in overrides:
                out.append(e)
        out.extend(e for e in overrides.values() if e is not None)
        return out

    def header_ledger_seq(self) -> int:
        return self.header().ledgerSeq


_OFFER_PREFIX = T.LedgerEntryType.encode(T.LedgerEntryType.OFFER)


class LedgerTxnRoot(AbstractLedgerTxn):
    """Root layer: entry store + header.  Point reads are served from the
    bucket tier when BucketListDB mode is enabled (ref BucketListDB /
    EXPERIMENTAL_BUCKETLIST_DB: the bucket list with per-bucket indexes
    IS the ledger-state database, SQL keeps only the offer-book range
    scans); otherwise — and always for offer/prefix scans — SQLite with
    the per-type SQL adapters collapsed into a keyed store + an offers
    index (SURVEY.md §2.4/§2.11)."""

    ENTRY_CACHE_SIZE = 8192

    def __init__(self, db, bucket_list=None):
        self.db = db
        self._child: Optional[LedgerTxn] = None
        self._header_cache = None
        # decoded-entry cache incl. negative results (ref LedgerTxnRoot's
        # EntryCache + prefetch machinery, LedgerTxnImpl.h); entries are
        # immutable namedtuples so sharing decoded objects is safe
        from collections import OrderedDict

        self._entry_cache: "OrderedDict[bytes, Optional[object]]" = \
            OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0
        # -- BucketListDB read mode ----------------------------------------
        # bucket_list: zero-arg callable returning the live BucketList
        # (late-bound: restore/assume swap the list object).  Reads only
        # divert once enable_bucket_reads() ran — the Application enables
        # it on a fresh start or after a hash-verified bucket restore, so
        # a node whose bucket store is missing/stale keeps SQL serving.
        self._bucket_list = bucket_list
        self.bucket_reads_enabled = False
        # writes committed to SQL OUTSIDE a ledger close (genesis seeding,
        # test-rig bulk writers) never reach the bucket list; this overlay
        # keeps them visible to the bucket read path.  Close deltas enter
        # at commit and are dropped again once the close's add_batch has
        # folded them into the buckets (LedgerManager calls
        # note_bucket_applied), so in steady state it holds only the
        # never-closed stragglers.
        self._sql_ahead: Dict[bytes, Optional[object]] = {}
        # -- write-ahead overlay (pipelined close) -------------------------
        # a SEALED close's delta whose SQL commit is still running on
        # the close-pipeline tail worker: reads must see it (SQL is one
        # ledger behind), offer scans must let it shadow SQL rows.
        # Close-thread only: installed by stage_sealed at seal, dropped
        # by clear_pending once the tail's commit is durable; the tail
        # worker writes SQL from its own captured delta reference and
        # never touches these dicts.
        self._pending: Dict[bytes, Optional[object]] = {}
        self._pending_offers: Dict[bytes, Optional[object]] = {}
        self.reads_from_buckets = 0
        self.reads_from_sql = 0
        self.reads_from_overlay = 0
        # keys the close pipeline's prefetch worker walked in the bucket
        # tier (note_bucket_walk), and the seconds of every bucket-tier
        # read: get, prefetch and the worker's walks (state_read_stats)
        self.reads_from_bucket_walks = 0
        self.bucket_read_seconds = 0.0

    def enable_bucket_reads(self) -> None:
        if self._bucket_list is not None:
            self.bucket_reads_enabled = True

    def _bucket_reads_on(self) -> bool:
        return self.bucket_reads_enabled and self._bucket_list is not None

    # -- reads -------------------------------------------------------------

    def _cache_put(self, kb: bytes, entry) -> None:
        c = self._entry_cache
        c[kb] = entry
        c.move_to_end(kb)
        while len(c) > self.ENTRY_CACHE_SIZE:
            c.popitem(last=False)

    def clear_entry_cache(self) -> None:
        """Required after any write that bypasses _commit_from_child
        (bucket-apply catchup wiping the SQL store).  The sql-ahead
        overlay clears with it: callers that wipe the store are about to
        make the bucket list authoritative."""
        self._entry_cache.clear()
        self._sql_ahead.clear()
        self._pending.clear()
        self._pending_offers.clear()

    # -- write-ahead overlay (pipelined close) ------------------------------

    def stage_sealed(self, delta: Dict[bytes, Optional[object]],
                     header) -> None:
        """Apply a sealed close's IN-MEMORY commit effects now, before
        its SQL commit runs on the tail worker: write-ahead overlay +
        entry-cache write-through + header cache.  Mirrors the memory
        half of _commit_from_child exactly (including the sql-ahead
        add-then-drop net effect: the bucket list already folded this
        delta in at phase 5, so the buckets answer for these keys)."""
        for kb, entry in sorted(delta.items()):
            if kb.startswith(VIRTUAL_PREFIX):
                if entry is not None:
                    raise LedgerTxnError(
                        "live virtual entry at root commit (unclosed "
                        "sponsorship)")
                continue
            self._pending[kb] = entry
            if kb.startswith(_OFFER_PREFIX):
                self._pending_offers[kb] = entry
            self._cache_put(kb, entry)
            self._sql_ahead.pop(kb, None)
        if header is not None:
            self._header_cache = header

    def clear_pending(self) -> None:
        """The staged delta is durably committed — SQL answers now."""
        self._pending.clear()
        self._pending_offers.clear()

    def commit_pending_sql(self, delta: Dict[bytes, Optional[object]],
                           header) -> None:
        """SQL-only half of a root commit, for the close-pipeline tail
        worker: stage_sealed already ran the memory half on the close
        thread.  The caller owns transaction boundaries (write_txn +
        one commit over the whole tail)."""
        self._commit_sql(self.db.cursor(), delta, header)

    def adopt_prefetch(self, found: Dict[bytes, Optional[object]]
                       ) -> int:
        """Fold a worker-prefetched key->entry batch into the entry
        cache.  Keys the cache/overlays already answer are skipped —
        those copies are newer than the bucket snapshot the prefetch
        walked."""
        n = 0
        for kb in sorted(found):
            if kb in self._entry_cache or kb in self._pending or \
                    kb in self._sql_ahead:
                continue
            self._cache_put(kb, found[kb])
            n += 1
        return n

    def note_bucket_walk(self, keys: int, seconds: float) -> None:
        """Count a walk of ``keys`` keys over a snapshot of the bucket
        tier that another thread made for this root (the close
        pipeline's prefetch worker), and its seconds."""
        self.reads_from_bucket_walks += keys
        self.bucket_read_seconds += seconds

    def note_bucket_applied(self, kbs) -> None:
        """A ledger close folded these keys into the bucket list — the
        buckets now answer for them, drop the overlay copies."""
        for kb in kbs:
            self._sql_ahead.pop(kb, None)

    def load_sql_ahead(self, kbs) -> None:
        """Rebuild the overlay after a restart from its persisted key
        list (LedgerManager stores it with the bucket state): each key's
        current SQL row is authoritative — including absence, which must
        shadow any stale bucket entry as a deletion."""
        for kb in kbs:
            row = self.db.execute(
                "SELECT entry FROM ledgerentries WHERE key = ?",
                (kb,)).fetchone()
            self._sql_ahead[kb] = (T.LedgerEntry.decode(row[0])
                                   if row is not None else None)

    def prefetch(self, kbs) -> int:
        """Bulk-load entries into the cache ahead of an apply loop (ref
        LedgerTxnRoot::prefetch).  Returns the number of keys newly
        cached (positive or negative).  BucketListDB mode feeds this from
        the bucket tier's batched lookup — zero SQL on the point path."""
        missing = [kb for kb in kbs if kb not in self._entry_cache]
        n = 0
        if self._pending:
            # sealed-but-uncommitted close delta: authoritative over
            # both SQL (one ledger behind) and the buckets (which agree
            # — phase 5 folded it in — but the dict hit is cheaper)
            left = []
            for kb in missing:
                if kb in self._pending:
                    self.reads_from_overlay += 1
                    self._cache_put(kb, self._pending[kb])
                    n += 1
                else:
                    left.append(kb)
            missing = left
        if self._bucket_reads_on():
            ask = []
            for kb in missing:
                if kb in self._sql_ahead:
                    self.reads_from_overlay += 1
                    self._cache_put(kb, self._sql_ahead[kb])
                    n += 1
                else:
                    ask.append(kb)
            if ask:
                with stopwatch() as sw:
                    found = self._bucket_list().get_entries(ask)
                self.reads_from_buckets += len(ask)
                self.bucket_read_seconds += sw.seconds
                for kb in ask:
                    self._cache_put(kb, found.get(kb))
                    n += 1
            return n
        for i in range(0, len(missing), 500):
            chunk = missing[i:i + 500]
            marks = ",".join("?" * len(chunk))
            found = dict(self.db.execute(
                f"SELECT key, entry FROM ledgerentries "
                f"WHERE key IN ({marks})", chunk))
            self.reads_from_sql += len(chunk)
            for kb in chunk:
                blob = found.get(kb)
                self._cache_put(
                    kb, T.LedgerEntry.decode(blob)
                    if blob is not None else None)
                n += 1
        return n

    def state_read_stats(self) -> Tuple[int, int, float]:
        """Cumulative (entry-cache misses of ``get``; keys read from the
        bucket tier: those ``get`` and ``prefetch`` found missing from
        the cache, and every key of the prefetch worker's walks; the
        seconds of those reads): the ledger's record takes their
        deltas."""
        return (self.cache_misses,
                self.reads_from_buckets + self.reads_from_bucket_walks,
                self.bucket_read_seconds)

    def prefetch_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def get(self, kb: bytes):
        cached = self._entry_cache.get(kb, _CACHE_MISS)
        if cached is not _CACHE_MISS:
            self.cache_hits += 1
            self._entry_cache.move_to_end(kb)
            return cached
        self.cache_misses += 1
        if self._pending and kb in self._pending:
            self.reads_from_overlay += 1
            entry = self._pending[kb]
            self._cache_put(kb, entry)
            return entry
        if self._bucket_reads_on():
            if kb in self._sql_ahead:
                self.reads_from_overlay += 1
                entry = self._sql_ahead[kb]
            else:
                self.reads_from_buckets += 1
                with stopwatch() as sw:
                    entry = self._bucket_list().get_entry(kb)
                self.bucket_read_seconds += sw.seconds
        else:
            self.reads_from_sql += 1
            row = self.db.execute(
                "SELECT entry FROM ledgerentries WHERE key = ?", (kb,)
            ).fetchone()
            entry = (T.LedgerEntry.decode(row[0])
                     if row is not None else None)
        self._cache_put(kb, entry)
        return entry

    def header(self):
        if self._header_cache is None:
            row = self.db.execute(
                "SELECT data FROM ledgerheaders "
                "ORDER BY ledgerseq DESC LIMIT 1").fetchone()
            if row is None:
                raise LedgerTxnError("no ledger header")
            self._header_cache = T.LedgerHeader.decode(row[0])
        return self._header_cache

    # -- commit ------------------------------------------------------------

    def _commit_from_child(self, delta: Dict[bytes, Optional[object]],
                           header) -> None:
        from contextlib import nullcontext

        # direct commits serialize against the close pipeline's tail
        # transaction so neither can commit the other's partial writes
        # (Database carries the lock; raw sqlite connections in tests
        # never share threads)
        lock = getattr(self.db, "write_txn", None)
        with (lock() if lock is not None else nullcontext()):
            for kb, entry in sorted(delta.items()):
                if kb.startswith(VIRTUAL_PREFIX):
                    if entry is not None:
                        raise LedgerTxnError(
                            "live virtual entry at root commit (unclosed "
                            "sponsorship)")
                    continue
                self._cache_put(kb, entry)  # write-through (None=deleted)
                if self._bucket_list is not None:
                    # keep the write visible to bucket-mode reads until
                    # the close folds it into the buckets
                    # (note_bucket_applied); direct (non-close) commits
                    # stay here for good.  Tracked even while bucket
                    # reads are OFF: the overlay key list persists with
                    # the bucket state, and a node later restarted with
                    # BUCKETLIST_DB on must still know which entries
                    # only ever lived in SQL
                    self._sql_ahead[kb] = entry
            self._commit_sql(self.db.cursor(), delta, header)
            if header is not None:
                self._header_cache = header
            self.db.commit()

    def _commit_sql(self, cur, delta: Dict[bytes, Optional[object]],
                    header) -> None:
        """The SQL statements of a root commit (no commit, no cache or
        overlay maintenance) — shared by the synchronous commit path
        and the pipelined tail's ``commit_pending_sql``."""
        for kb, entry in sorted(delta.items()):
            if kb.startswith(VIRTUAL_PREFIX):
                continue
            if entry is None:
                cur.execute("DELETE FROM ledgerentries WHERE key = ?", (kb,))
                cur.execute("DELETE FROM offers WHERE key = ?", (kb,))
            else:
                # encode first: a PackedEntry from the native apply
                # kernel serves its bytes via the LedgerEntry memo, and
                # the entry type reads off the key's discriminant — the
                # packed delta commits without decoding (ledger/packed)
                eb = T.LedgerEntry.encode(entry)
                et = entry_type_from_key(kb)
                cur.execute(
                    "INSERT INTO ledgerentries(key, type, entry) "
                    "VALUES(?,?,?) ON CONFLICT(key) DO UPDATE SET "
                    "entry=excluded.entry",
                    (kb, et, eb))
                if et == T.LedgerEntryType.OFFER:
                    o = entry.data.value
                    # the REAL price column is an INDEX approximation
                    # (ORDER BY prefilter); exact pricen/priced ride
                    # alongside and _best_offer re-compares float ties
                    # exactly
                    # detlint: allow(det-float-consensus)
                    price_approx = o.price.n / o.price.d
                    cur.execute(
                        "INSERT INTO offers(key, sellerid, offerid, "
                        "selling, buying, price, pricen, priced, amount) "
                        "VALUES(?,?,?,?,?,?,?,?,?) ON CONFLICT(key) DO "
                        "UPDATE SET selling=excluded.selling, "
                        "buying=excluded.buying, price=excluded.price, "
                        "pricen=excluded.pricen, priced=excluded.priced, "
                        "amount=excluded.amount",
                        (kb, o.sellerID.value, o.offerID,
                         T.Asset.encode(o.selling), T.Asset.encode(o.buying),
                         price_approx, o.price.n, o.price.d,
                         o.amount))
        if header is not None:
            hb = T.LedgerHeader.encode(header)
            cur.execute(
                "INSERT INTO ledgerheaders(ledgerseq, data) VALUES(?,?) "
                "ON CONFLICT(ledgerseq) DO UPDATE SET data=excluded.data",
                (header.ledgerSeq, hb))

    # -- order-book scan ---------------------------------------------------

    def _best_offer(self, selling: bytes, buying: bytes,
                    overrides: Dict[bytes, Optional[object]],
                    worse_than=None):
        """Lowest-price offer for the pair, merging the SQL index with the
        uncommitted overrides.  worse_than: (Fraction-price, offerID)
        exclusive lower bound for iteration.

        Price comparisons are EXACT rationals (Fraction): the REAL
        ``price`` column only prefilters the SQL scan, so two distinct
        rationals colliding in double precision cannot flip the crossing
        order — the float tie-run is re-compared exactly below."""
        if self._pending_offers:
            # sealed-but-uncommitted close delta shadows SQL rows; the
            # open txn's own overrides stay newest
            overrides = {**self._pending_offers, **overrides}
        candidates = []
        q = ("SELECT key, pricen, priced, offerid FROM offers "
             "WHERE selling = ? AND buying = ? ORDER BY price, offerid")
        first_tie = None  # float price of the first unshadowed row
        for kb, pn, pd, oid in self.db.execute(q, (selling, buying)):
            if kb in overrides:
                continue  # shadowed by the open txn
            key = (Fraction(pn, pd), oid)
            if worse_than is not None and key <= worse_than:
                continue
            # collect the whole run of rows tied at the first float
            # price — exact order may disagree inside the tie
            # detlint: allow(det-float-consensus)
            approx = pn / pd
            if first_tie is None:
                first_tie = approx
            elif approx != first_tie:
                break  # beyond the tie-run: float order is exact order
            candidates.append((*key, kb))
        for kb, e in sorted(overrides.items()):
            if e is None:
                continue
            o = e.data.value
            if (T.Asset.encode(o.selling) != selling
                    or T.Asset.encode(o.buying) != buying):
                continue
            key = (Fraction(o.price.n, o.price.d), o.offerID)
            if worse_than is not None and key <= worse_than:
                continue
            candidates.append((*key, kb))
        if not candidates:
            return None
        candidates.sort()
        kb = candidates[0][2]
        e = overrides.get(kb)
        if e is None:
            e = self.get(kb)
        return e

    def _entries_by_key_prefix(self, prefix: bytes):
        pend = self._pending
        hi = prefix + b"\xff" * 8
        for kb, blob in self.db.execute(
                "SELECT key, entry FROM ledgerentries "
                "WHERE key >= ? AND key <= ?", (prefix, hi)):
            if kb.startswith(prefix) and kb not in pend:
                yield kb, T.LedgerEntry.decode(blob)
        if pend:
            for kb in sorted(pend):
                if kb.startswith(prefix) and pend[kb] is not None:
                    yield kb, pend[kb]

    def _offers_by_pair(self, selling: bytes, buying: bytes):
        """Every resting offer of one book direction — the parallel-apply
        planner's order-book materialization (plan-time, main thread).
        The write-ahead overlay shadows SQL rows; consumers sort the
        rows themselves, so the appended overlay offers need no order
        merge."""
        pend = self._pending_offers
        for kb, blob in self.db.execute(
                "SELECT o.key, e.entry FROM offers o "
                "JOIN ledgerentries e ON e.key = o.key "
                "WHERE o.selling = ? AND o.buying = ? "
                "ORDER BY o.price, o.offerid", (selling, buying)):
            if kb not in pend:
                yield kb, T.LedgerEntry.decode(blob)
        if pend:
            for kb in sorted(pend):
                e = pend[kb]
                if e is None:
                    continue
                o = e.data.value
                if (T.Asset.encode(o.selling) == selling
                        and T.Asset.encode(o.buying) == buying):
                    yield kb, e

    def _offers_by_seller(self, sellerid: bytes):
        pend = self._pending_offers
        for kb, blob in self.db.execute(
                "SELECT o.key, e.entry FROM offers o "
                "JOIN ledgerentries e ON e.key = o.key "
                "WHERE o.sellerid = ?", (sellerid,)):
            if kb not in pend:
                yield kb, T.LedgerEntry.decode(blob)
        if pend:
            for kb in sorted(pend):
                e = pend[kb]
                if e is not None and \
                        e.data.value.sellerID.value == sellerid:
                    yield kb, e

    def count_entries(self) -> int:
        return self.db.execute(
            "SELECT COUNT(*) FROM ledgerentries").fetchone()[0]

    def all_entries(self) -> Iterable[object]:
        for (blob,) in self.db.execute(
                "SELECT entry FROM ledgerentries ORDER BY key"):
            yield T.LedgerEntry.decode(blob)


SCHEMA = """
CREATE TABLE IF NOT EXISTS ledgerentries (
    key BLOB PRIMARY KEY,
    type INTEGER NOT NULL,
    entry BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_entries_type ON ledgerentries(type);
CREATE TABLE IF NOT EXISTS offers (
    key BLOB PRIMARY KEY,
    sellerid BLOB NOT NULL,
    offerid INTEGER NOT NULL,
    selling BLOB NOT NULL,
    buying BLOB NOT NULL,
    price REAL NOT NULL,
    pricen INTEGER NOT NULL,
    priced INTEGER NOT NULL,
    amount INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_offers_book
    ON offers(selling, buying, price, offerid);
CREATE INDEX IF NOT EXISTS idx_offers_seller ON offers(sellerid);
CREATE TABLE IF NOT EXISTS ledgerheaders (
    ledgerseq INTEGER PRIMARY KEY,
    data BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS persistentstate (
    statename TEXT PRIMARY KEY,
    state TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS txhistory (
    txid BLOB NOT NULL,
    ledgerseq INTEGER NOT NULL,
    txindex INTEGER NOT NULL,
    txbody BLOB NOT NULL,
    txresult BLOB NOT NULL,
    txmeta BLOB NOT NULL,
    PRIMARY KEY (ledgerseq, txindex)
);
CREATE TABLE IF NOT EXISTS scphistory (
    nodeid BLOB NOT NULL,
    ledgerseq INTEGER NOT NULL,
    envelope BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS scpquorums (
    qsethash BLOB PRIMARY KEY,
    lastledgerseq INTEGER NOT NULL,
    qset BLOB NOT NULL
);
"""


def open_database(path: str = ":memory:"):
    import sqlite3

    db = sqlite3.connect(path)
    db.executescript(SCHEMA)
    return db
