"""Command line: the operator entry point
(ref src/main/CommandLine.cpp:1825-1891 subcommand table; clara parsing
collapses to argparse).

Subcommands: run, new-db, catchup, publish, http-command, version,
self-check.  `python -m stellar_core_tpu_torch --conf node.toml run` runs a node
as an OS process: real TCP overlay (PEER_PORT), admin HTTP (HTTP_PORT),
SCP cadence on the real-time clock.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from ..utils.clock import ClockMode, VirtualClock
from .application import Application
from .config import Config


def load_config(path: Optional[str], overrides: dict) -> Config:
    if path:
        cfg = Config.from_toml(path)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
    return Config(**overrides)


def cmd_run(cfg: Config) -> int:
    """ref run(): boot + crank the real-time main loop forever."""
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.enable_tcp()
    app.start()
    info = app.get_json_info()
    print(json.dumps({"starting": info}), flush=True)
    import time

    try:
        last_gc = time.monotonic()
        while True:
            if app.crank(block=False) == 0:
                # idle: nap briefly, then poll sockets/timers again (the
                # asio run-loop equivalent)
                time.sleep(0.005)
                # DEFERRED_GC residual: a node that is idle (not closing
                # ledgers — out of sync, or serving HTTP only) must
                # still collect now and then, else cyclic garbage grows
                # unboundedly with automatic GC off
                if cfg.DEFERRED_GC and \
                        time.monotonic() - last_gc > 30.0:
                    import gc

                    gc.collect(1)
                    last_gc = time.monotonic()
    except KeyboardInterrupt:
        app.graceful_stop()
    return 0


def cmd_new_db(cfg: Config) -> int:
    """ref newDB(): initialize the database + genesis ledger."""
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.ledger_manager.start_new_ledger()
    print(json.dumps({
        "ledger": app.ledger_manager.last_closed_seq(),
        "hash": app.ledger_manager.last_closed_hash().hex()}))
    return 0


def cmd_catchup(cfg: Config, to_ledger: int, mode: str) -> int:
    from ..catchup import CatchupConfiguration, CatchupWork
    from ..work.work import State

    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.start()
    if not app.history_manager.archives:
        print(json.dumps({"error": "no HISTORY_ARCHIVES configured"}))
        return 1
    archive = app.history_manager.archives[0]
    work = CatchupWork(app, archive, CatchupConfiguration(
        to_ledger,
        CatchupConfiguration.COMPLETE if mode == "complete"
        else CatchupConfiguration.MINIMAL))
    work.start()
    for _ in range(100000):
        work.crank()
        if work.state not in (State.RUNNING, State.WAITING):
            break
    print(json.dumps({
        "state": work.state.name,
        "ledger": app.ledger_manager.last_closed_seq(),
        "hash": app.ledger_manager.last_closed_hash().hex()}))
    return 0 if work.state == State.SUCCESS else 1


def cmd_publish(cfg: Config) -> int:
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.start()
    app.history_manager.publish_queued_history()
    print(json.dumps(
        {"published": app.history_manager.published_checkpoints}))
    return 0


def cmd_self_check(cfg: Config) -> int:
    """ref selfCheck(): verify local state consistency."""
    from ..xdr import types as T
    from ..xdr import xdr_sha256

    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.start()
    checks = {}
    lm = app.ledger_manager
    hdr = lm.last_closed_header()
    checks["header_hash"] = (
        lm.last_closed_hash() == xdr_sha256(T.LedgerHeader, hdr))
    checks["bucket_list"] = (
        app.bucket_manager.get_bucket_list_hash() == hdr.bucketListHash
        or hdr.bucketListHash == b"\x00" * 32)
    # BucketListIsConsistentWithDatabase (ref src/invariant/
    # BucketListIsConsistentWithDatabase.cpp, run here as the reference's
    # self-check does): the SQL entry store must hold exactly the bucket
    # list's live entries
    if app.bucket_manager.get_bucket_list_hash() != b"\x00" * 32 and \
            app.bucket_manager.bucket_list.levels[0].curr.entries:
        live = app.bucket_manager.bucket_list.all_live_entries()
        db_count = app.ledger_manager.root.count_entries()
        consistent = len(live) == db_count
        if consistent:
            for kb, entry in live.items():
                # straight SQL, NOT root.get: in BucketListDB mode the
                # root serves from the buckets, which would make this
                # cross-tier invariant compare the buckets to themselves
                row = app.database.execute(
                    "SELECT entry FROM ledgerentries WHERE key = ?",
                    (kb,)).fetchone()
                if row is None or row[0] != T.LedgerEntry.encode(entry):
                    consistent = False
                    break
        checks["bucketlist_consistent_with_database"] = consistent
    qic = app.herder.check_quorum_intersection()
    checks["quorum_intersection"] = qic.ok  # None = budget hit: unknown
    ok = all(v is not False for v in checks.values())
    print(json.dumps({"ok": ok, "checks": checks}))
    return 0 if ok else 1


def cmd_version() -> int:
    print(json.dumps({"version": "stellar-core-tpu-torch 0.3.0",
                      "protocol": Config.CURRENT_LEDGER_PROTOCOL_VERSION}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stellar-core-tpu-torch")
    ap.add_argument("--conf", help="TOML config file")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("run")
    sub.add_parser("new-db")
    cu = sub.add_parser("catchup")
    cu.add_argument("to_ledger", type=int)
    cu.add_argument("--mode", choices=["minimal", "complete"],
                    default="minimal")
    sub.add_parser("publish")
    sub.add_parser("self-check")
    sub.add_parser("version")
    args = ap.parse_args(argv)

    if args.cmd == "version":
        return cmd_version()
    cfg = load_config(args.conf, {})
    if args.cmd == "run":
        return cmd_run(cfg)
    if args.cmd == "new-db":
        return cmd_new_db(cfg)
    if args.cmd == "catchup":
        return cmd_catchup(cfg, args.to_ledger, args.mode)
    if args.cmd == "publish":
        return cmd_publish(cfg)
    if args.cmd == "self-check":
        return cmd_self_check(cfg)
    return 2


if __name__ == "__main__":
    sys.exit(main())
