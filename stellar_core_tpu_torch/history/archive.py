"""History archives: checkpoint file layout + HistoryArchiveState (HAS)
(ref src/history/HistoryArchive.{h,cpp}, src/history/readme.md:8-30).

An archive is a directory tree (the reference's operator-configured
get/put command templates collapse to local filesystem ops here — the
test-suite model, ref HistoryConfigurator; remote transports slot in
behind the same get_file/put_file seam):

    .well-known/stellar-history.json          root HAS
    history/xx/yy/zz/history-XXXXXXXX.json    per-checkpoint HAS
    ledger/xx/yy/zz/ledger-XXXXXXXX.xdr.gz    LedgerHeaderHistoryEntry*
    transactions/.../transactions-XXXXXXXX.xdr.gz  TransactionHistoryEntry*
    results/.../results-XXXXXXXX.xdr.gz       TransactionHistoryResultEntry*
    scp/.../scp-XXXXXXXX.xdr.gz               SCPHistoryEntry*
    bucket/xx/yy/zz/bucket-<hex>.xdr.gz       BucketEntry* (by content hash)

XXXXXXXX is the checkpoint ledger seq in 8-hex-digit form; xx/yy/zz are its
first three byte pairs (ref fs::hexDir layout).
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional

HAS_VERSION = 1


def checkpoint_name(seq: int) -> str:
    return f"{seq:08x}"


def _hex_dir(name: str) -> str:
    return os.path.join(name[0:2], name[2:4], name[4:6])


def category_path(category: str, name: str, ext: str) -> str:
    return os.path.join(category, _hex_dir(name),
                        f"{category}-{name}{ext}")


class HistoryArchiveState:
    """The HAS JSON: checkpoint ledger + the 11 levels' bucket hashes
    (ref HistoryArchiveState; 'next' merge-futures are always clear here —
    merges are synchronous in this framework)."""

    def __init__(self, current_ledger: int = 0,
                 buckets: Optional[List[Dict[str, str]]] = None,
                 network_passphrase: str = ""):
        self.version = HAS_VERSION
        self.server = "stellar-core-tpu"
        self.current_ledger = current_ledger
        self.network_passphrase = network_passphrase
        self.buckets = buckets or [
            {"curr": "00" * 32, "snap": "00" * 32}
            for _ in range(11)]

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "server": self.server,
            "currentLedger": self.current_ledger,
            "networkPassphrase": self.network_passphrase,
            "currentBuckets": [
                {"curr": b["curr"], "snap": b["snap"],
                 "next": {"state": 0}}
                for b in self.buckets],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "HistoryArchiveState":
        d = json.loads(s)
        has = cls(d["currentLedger"],
                  [{"curr": b["curr"], "snap": b["snap"]}
                   for b in d["currentBuckets"]],
                  d.get("networkPassphrase", ""))
        has.server = d.get("server", "")
        return has

    def all_bucket_hashes(self) -> List[str]:
        out = []
        for b in self.buckets:
            out.append(b["curr"])
            out.append(b["snap"])
        return out


class HistoryArchive:
    """One archive backed by a local directory."""

    # local-filesystem transfers are safe to run from the scheduler's
    # worker pool (catchup's parallel downloads)
    thread_safe = True

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root

    # -- raw file ops (the get/put command-template seam) -------------------

    def _abs(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def put_file(self, rel: str, data: bytes) -> None:
        path = self._abs(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)

    def get_file(self, rel: str) -> Optional[bytes]:
        try:
            with open(self._abs(rel), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def has_file(self, rel: str) -> bool:
        return os.path.exists(self._abs(rel))

    # -- typed helpers ------------------------------------------------------

    def put_xdr_gz(self, category: str, name: str, payload: bytes) -> None:
        self.put_file(category_path(category, name, ".xdr.gz"),
                      gzip.compress(payload))

    def get_xdr_gz(self, category: str, name: str) -> Optional[bytes]:
        raw = self.get_file(category_path(category, name, ".xdr.gz"))
        return gzip.decompress(raw) if raw is not None else None

    def put_bucket(self, hash_hex: str, payload: bytes) -> None:
        if hash_hex == "00" * 32:
            return
        rel = category_path("bucket", hash_hex, ".xdr.gz")
        if not self.has_file(rel):  # content-addressed: write once
            self.put_file(rel, gzip.compress(payload))

    def get_bucket(self, hash_hex: str) -> Optional[bytes]:
        if hash_hex == "00" * 32:
            return b""
        raw = self.get_file(category_path("bucket", hash_hex, ".xdr.gz"))
        return gzip.decompress(raw) if raw is not None else None

    def has_bucket(self, hash_hex: str) -> bool:
        """Cheap existence probe (content-addressed, so presence implies
        the right bytes); CommandArchive inherits the conservative
        put-memo has_file."""
        if hash_hex == "00" * 32:
            return True
        return self.has_file(category_path("bucket", hash_hex, ".xdr.gz"))

    def put_has(self, has: HistoryArchiveState) -> None:
        name = checkpoint_name(has.current_ledger)
        data = has.to_json().encode()
        self.put_file(category_path("history", name, ".json"), data)
        self.put_file(os.path.join(".well-known",
                                   "stellar-history.json"), data)

    def get_root_has(self) -> Optional[HistoryArchiveState]:
        raw = self.get_file(os.path.join(".well-known",
                                         "stellar-history.json"))
        if raw is None:
            return None
        return HistoryArchiveState.from_json(raw.decode())

    def get_checkpoint_has(self, seq: int) -> Optional[HistoryArchiveState]:
        raw = self.get_file(category_path(
            "history", checkpoint_name(seq), ".json"))
        if raw is None:
            return None
        return HistoryArchiveState.from_json(raw.decode())


class CommandArchive(HistoryArchive):
    """Archive whose transfers run operator-configured shell command
    templates as subprocesses (ref src/history/readme.md:8-30: `get`/`put`
    templates with ``{0}`` = local file, ``{1}`` = archive-relative path,
    e.g. ``get = "curl -sf http://archive/{1} -o {0}"`` or
    ``put = "aws s3 cp {0} s3://bucket/{1}"``).  Each transfer routes
    through RunCommandWork -> ProcessManager (the reference's
    GetRemoteFileWork/PutRemoteFileWork -> posix_spawnp pipeline,
    ref src/process/ProcessManagerImpl.cpp:825) and is driven to
    completion here: publish/catchup steps treat a transfer as one
    synchronous unit, with subprocess isolation and the operator's
    transport of choice."""

    # transfers poll the main-thread ProcessManager — catchup must not
    # dispatch them to the worker pool
    thread_safe = False

    def __init__(self, name: str, get_cmd: Optional[str] = None,
                 put_cmd: Optional[str] = None,
                 mkdir_cmd: Optional[str] = None,
                 process_manager=None, tmp_dir: Optional[str] = None):
        import tempfile

        super().__init__(name, root="")
        self.get_cmd = get_cmd
        self.put_cmd = put_cmd
        self.mkdir_cmd = mkdir_cmd
        self.pm = process_manager
        self.tmp_dir = tmp_dir or tempfile.mkdtemp(
            prefix=f"archive-{name}-")
        self._tmp_count = 0
        self._put_memo: set = set()  # rels put by this process

    def _run(self, cmd: str) -> bool:
        import time as _time

        from ..process.process_manager import RunCommandWork
        from ..work.work import State

        work = RunCommandWork(self.pm, cmd, name=f"archive:{self.name}")
        state = work.on_run()
        while state == State.RUNNING:
            _time.sleep(0.004)
            state = work.on_run()
        return state == State.SUCCESS

    def _tmp_path(self) -> str:
        self._tmp_count += 1
        return os.path.join(self.tmp_dir, f"xfer-{self._tmp_count}")

    def put_file(self, rel: str, data: bytes) -> None:
        if self.put_cmd is None:
            raise RuntimeError(f"archive {self.name} has no put command")
        local = self._tmp_path()
        with open(local, "wb") as f:
            f.write(data)
        try:
            if self.mkdir_cmd is not None:
                self._run(self.mkdir_cmd.format(os.path.dirname(rel)))
            if not self._run(self.put_cmd.format(local, rel)):
                raise RuntimeError(
                    f"archive {self.name}: put failed for {rel}")
            self._put_memo.add(rel)
        finally:
            try:
                os.unlink(local)
            except OSError:
                pass

    def get_file(self, rel: str) -> Optional[bytes]:
        if self.get_cmd is None:
            return None
        local = self._tmp_path()
        try:
            if not self._run(self.get_cmd.format(local, rel)):
                return None
            try:
                with open(local, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None
        finally:
            try:
                os.unlink(local)
            except OSError:
                pass

    def has_file(self, rel: str) -> bool:
        # no cheap existence probe over a command transport; remember
        # what this process already put (bucket files are content-
        # addressed, so the only cost of a conservative False is a
        # redundant re-upload after restart)
        return rel in self._put_memo
