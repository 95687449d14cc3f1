"""Database: the SQL session wrapper — prepared-statement cache + query
timers (ref src/database/Database.h:87-122 — SOCI collapses to sqlite3;
the statement cache maps to sqlite3's compiled-statement LRU, sized
explicitly like mStatements, and per-query timers feed the metrics
registry like the reference's mQueryMeter/timers)."""
from __future__ import annotations

import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..ledger.ledger_txn import SCHEMA
from ..utils.lockdep import guard_fields, register_lock

STATEMENT_CACHE_SIZE = 100


class Database:
    def __init__(self, path: str = ":memory:", metrics=None,
                 slow_query_seconds: float = 0.25):
        self.path = path
        # check_same_thread=False: the pipelined close commits ledger
        # N's tail from a dedicated worker while the main thread reads
        # (and SQLite's serialized mode makes each call safe).  Commit
        # boundaries are serialized via _write_lock so no thread can
        # commit another's half-written transaction.
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self._write_lock = register_lock(threading.RLock(), "db.write")
        # sqlite's compiled-statement cache IS the prepared-statement
        # cache seam (ref Database::getPreparedStatement)
        self.conn.execute(f"PRAGMA cache_size=-{4096}")
        self.conn.executescript(SCHEMA)
        try:
            self.conn.set_trace_callback(None)
        except AttributeError:
            pass
        self.metrics = metrics
        self.slow_query_seconds = slow_query_seconds
        self.queries = 0       # guarded-by: _write_lock
        self.slow_queries = 0  # guarded-by: _write_lock
        # each thread's commits (count, seconds) since it last took them
        # (take_commit_stats): the close thread and the close's tail
        # worker each account for their own flushes
        self._commits = threading.local()
        guard_fields(self)

    # -- the reference's session surface ------------------------------------

    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        t0 = time.perf_counter()
        try:
            if sql.lstrip()[:6].upper() == "SELECT":
                # reads run lock-free: sqlite's serialized mode makes
                # the call itself safe, and reads never trigger the
                # sqlite3 module's implicit BEGIN (whose not-thread-
                # aware bookkeeping is why writes must serialize)
                return self.conn.execute(sql, params)
            with self._write_lock:
                return self.conn.execute(sql, params)
        finally:
            self._account(sql, time.perf_counter() - t0)

    def executemany(self, sql: str, seq) -> sqlite3.Cursor:
        t0 = time.perf_counter()
        try:
            with self._write_lock:
                return self.conn.executemany(sql, seq)
        finally:
            self._account(sql, time.perf_counter() - t0)

    def cursor(self) -> sqlite3.Cursor:
        return self.conn.cursor()

    def commit(self) -> None:
        with self._write_lock:
            t0 = time.perf_counter()
            self.conn.commit()
            dt = time.perf_counter() - t0
        mine = self._commits
        mine.n = getattr(mine, "n", 0) + 1
        mine.seconds = getattr(mine, "seconds", 0.0) + dt

    def take_commit_stats(self) -> tuple:
        """(commits, seconds flushing them) that the calling thread made
        since it last took them; the count starts again from zero."""
        mine = self._commits
        out = (getattr(mine, "n", 0), getattr(mine, "seconds", 0.0))
        mine.n, mine.seconds = 0, 0.0
        return out

    @contextmanager
    def write_txn(self):
        """Exclusive multi-statement transaction scope: holds the write
        lock so no other thread's ``commit`` can land mid-sequence, and
        rolls the connection back if the body raises (a failed
        pipelined tail must not leave half a close for the next commit
        to flush).  The body calls ``commit()`` itself — the lock is
        re-entrant."""
        with self._write_lock:
            try:
                yield self.conn
            except BaseException:
                try:
                    self.conn.rollback()
                except sqlite3.Error:
                    pass  # connection already closed/poisoned
                raise

    def close(self) -> None:
        self.conn.close()

    def _account(self, sql: str, dt: float) -> None:
        slow = dt > self.slow_query_seconds
        # the write paths already hold the re-entrant lock; the lock-free
        # SELECT path pays one uncontended RLock acquire so the counters
        # stay exact under the pipelined tail (detlint
        # conc-unguarded-shared found the lost-increment race)
        with self._write_lock:
            self.queries += 1
            if slow:
                self.slow_queries += 1
        if self.metrics is not None:
            self.metrics.timer("database.query").update(dt)
        if slow:
            from ..utils.logging import get_logger

            get_logger("Database").warning(
                "slow query (%.3fs): %s", dt, sql.split("\n")[0][:120])

    # -- maintenance ---------------------------------------------------------

    def total_changes(self) -> int:
        return self.conn.total_changes
