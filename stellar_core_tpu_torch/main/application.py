"""Application: the container that owns and wires every subsystem
(ref src/main/Application.h:132-318, ApplicationImpl.cpp — SURVEY.md §2.10).

Construction wires: clock -> metrics -> database -> bucket manager ->
ledger manager -> invariants -> herder -> (overlay, history when
configured).  ``start()`` mirrors ApplicationImpl::start() :772-821:
load-or-create ledger -> herder start -> overlay start.
"""
from __future__ import annotations

from typing import List, Optional

from ..bucket.bucket_list import BucketManager
from ..herder.herder import Herder
from ..invariant.manager import InvariantManager
from ..ledger.ledger_manager import LedgerManager
from ..utils.clock import ClockMode, VirtualClock
from ..utils.metrics import Gauge, MetricsRegistry
from ..utils.scheduler import Scheduler
from ..work.work import WorkScheduler
from ..xdr import types as T
from .config import Config

# process-global one-shot flag for the deferred-GC policy
_GC_DEFERRED = False


class KernelLaunches(Gauge):
    """The verify kernel's launches in this process: the wrapper's own
    count (``ops/ed25519_cuda.launches``, raised where the kernel is
    launched and nowhere else), read whenever the registry is scraped."""

    @property
    def value(self) -> float:
        from ..ops import ed25519_cuda

        return float(ed25519_cuda.launches)

    @value.setter
    def value(self, v) -> None:
        pass  # read-only: the wrapper's counter is the count


class Application:
    def __init__(self, clock: VirtualClock, config: Config, device=None):
        self.clock = clock
        self.config = config
        # resolve "auto" device backends once, before any subsystem reads
        # them: the device tiers, with no probe
        if config.CRYPTO_BACKEND == "auto":
            config.CRYPTO_BACKEND = "cuda"
        if config.SCP_TALLY_BACKEND == "auto":
            config.SCP_TALLY_BACKEND = "tensor"
        # the node's device, resolved once for every device tier: the GPU
        # unless ``device`` names another; with no GPU and no ``device``
        # this raises (never a quiet turn to the CPU).  A node on the
        # "cpu" / "host" backends needs none.
        self.device = None
        if config.CRYPTO_BACKEND == "cuda" or \
                config.SCP_TALLY_BACKEND in ("tensor", "both"):
            from ..utils.device import default_device

            self.device = default_device(device)
        self.metrics = MetricsRegistry(clock)
        if config.CRYPTO_BACKEND == "cuda":
            # ``crypto.verify.kernel-launches`` in /metrics (the registry
            # creates a metric of its own class on first use)
            self.metrics._get("crypto.verify.kernel-launches",
                              KernelLaunches)
        # flight recorder: span ring + slow-close watchdog (utils/tracing)
        from ..utils.tracing import Tracer

        self.tracer = Tracer(
            enabled=config.TRACING_ENABLED,
            ring_closes=config.TRACE_RING_CLOSES,
            slow_close_threshold=(
                config.SLOW_CLOSE_THRESHOLD_SECONDS
                if config.SLOW_CLOSE_THRESHOLD_SECONDS > 0 else None),
            trace_dir=config.TRACE_DIR,
            metrics=self.metrics)
        # tx-lifecycle telemetry: sampled per-tx stage stamps across
        # overlay/herder/ledger, rolled into txtrace.* histograms and
        # the tx/latency endpoint (utils/txtrace.py)
        from ..utils.txtrace import TxLifecycleTracker

        self.txtracer = TxLifecycleTracker(
            metrics=self.metrics,
            enabled=config.TX_LIFECYCLE_TRACKING,
            max_live=config.TX_LIFECYCLE_MAX_LIVE,
            ring=config.TX_LIFECYCLE_RING)
        # flood-propagation telemetry: per-item hop records across the
        # overlay flood, stamped on the shared clock so a simulation's
        # nodes produce cross-comparable (and deterministic) timelines
        # (utils/floodtrace.py; merged by simulation/observatory.py)
        from ..utils.floodtrace import FloodPropagationTracker

        self.floodtracer = FloodPropagationTracker(
            metrics=self.metrics,
            enabled=config.FLOOD_TRACE_ENABLED,
            now=clock.now,
            max_live=config.FLOOD_TRACE_MAX_LIVE,
            ring=config.FLOOD_TRACE_RING)
        self.scheduler = Scheduler(clock)
        from ..database import Database

        self.database = Database(config.DATABASE, metrics=self.metrics)
        self.bucket_manager = BucketManager(
            self, bucket_dir=getattr(config, "BUCKET_DIR_PATH_REAL", None))
        self.invariants = InvariantManager(config.INVARIANT_CHECKS)
        self.ledger_manager = LedgerManager(self)
        # parallel transaction apply: footprint planner + conflict
        # clusters + bit-identical concurrent executor (apply/), with
        # its own PR-1-style worker pool when enabled
        from ..apply import ParallelApplyManager

        self.parallel_apply = ParallelApplyManager(self)
        from ..work.work import WorkerPool

        self.work_scheduler = WorkScheduler(
            clock,
            worker_pool=(WorkerPool(config.WORK_POOL_WORKERS)
                         if getattr(config, "WORK_POOL_WORKERS", 4) > 0
                         else None))
        self.herder = Herder(self)
        self.overlay_manager = None   # wired by overlay.setup (optional)
        from ..process import ProcessManager

        # before HistoryManager: command-template archives transfer
        # through the process manager
        self.process_manager = ProcessManager(
            self, config.MAX_CONCURRENT_SUBPROCESSES)
        from ..history import HistoryManager

        self.history_manager = HistoryManager(self)
        from ..catchup import CatchupManager

        self.catchup_manager = CatchupManager(self)
        # continuous node-vitals sampler + SLO watchdog (utils/vitals):
        # constructed always (endpoints/report work either way), the
        # periodic timer + gc callback only engage via start()
        from ..utils.vitals import VitalsSampler

        self.vitals = VitalsSampler(self)
        import threading

        # LedgerCloseMeta ring: appended by whichever thread runs the
        # close path (main sequential, close tail pipelined — detlint
        # conc-unguarded-shared); reads (tests, forensics) are lock-free
        # list snapshots
        from ..utils.lockdep import register_lock

        self._meta_lock = register_lock(threading.Lock(), "app.meta")
        self._meta_stream: List = []  # guarded-by: _meta_lock
        self._started = False
        # real-socket mode (enable_tcp): io service + listeners
        self.tcp_io = None
        self.peer_door = None
        self.http_server = None

    # -- lifecycle (ref ApplicationImpl::start :772) ------------------------

    @classmethod
    def create(cls, clock: Optional[VirtualClock] = None,
               config: Optional[Config] = None,
               device=None) -> "Application":
        return cls(clock or VirtualClock(ClockMode.REAL_TIME),
                   config or Config(), device)

    def start(self) -> None:
        self.config.validate()
        if not T.ensure_native_encode():  # build once per checkout
            from ..native import get_xdrpack

            get_xdrpack()  # raises with the compiler's output
            raise RuntimeError("the native XDR encoder did not load")
        if self.config.DEFERRED_GC:
            # low-latency close discipline: a gen-2 cycle collection can
            # stall the single-threaded close loop for >1s (measured:
            # p99 1.45s vs p50 0.3s purely from GC).  Freeze the startup
            # arena, stop automatic collection, and collect explicitly
            # AFTER each close (LedgerManager._post_close_gc) where the
            # 5s cadence has idle room.  Process-global and one-shot: a
            # second Application in the same process must not re-freeze
            # (that would pin earlier apps' dead cycles forever).
            global _GC_DEFERRED
            if not _GC_DEFERRED:
                _GC_DEFERRED = True
                import gc

                gc.freeze()
                gc.disable()
        if self.ledger_manager.load_last_known_ledger():
            restored = self._restore_bucket_state()
            # BucketListDB reads only activate when the bucket list
            # provably matches the last closed header; a node without a
            # (verified) bucket store keeps serving reads from SQL
            if restored and self.config.BUCKETLIST_DB:
                self.ledger_manager.root.enable_bucket_reads()
                self._restore_sql_ahead()
        else:
            if self.config.BUCKETLIST_DB:
                # fresh start: the bucket list begins empty and every
                # close folds its delta in, so it stays authoritative
                # from genesis (direct writes ride the sql-ahead overlay)
                self.ledger_manager.root.enable_bucket_reads()
            self.ledger_manager.start_new_ledger()
        self.herder.start()
        if self.overlay_manager is not None:
            self.overlay_manager.start()
        if self.tcp_io is not None:
            self.connect_known_peers()
            # periodic connection top-up (ref OverlayManagerImpl::tick):
            # a one-shot dial would leave the node isolated forever when
            # it races a peer's listener coming up
            from ..utils.clock import VirtualTimer

            self._overlay_tick_timer = VirtualTimer(self.clock,
                                                    owner=self)
            self._arm_overlay_tick()
        self.history_manager.publish_queued_history()
        self.vitals.start()
        self._started = True

    def _restore_bucket_state(self) -> bool:
        """Reassume the bucket list from the persisted level hashes + the
        on-disk bucket files (ref ApplicationImpl::start :788 ->
        loadLastKnownLedger -> AssumeStateWork).  True when the restored
        list hash-matches the last closed header (the gate for
        BucketListDB reads)."""
        import json

        if self.bucket_manager.bucket_dir is None:
            # no on-disk bucket store configured: nothing to restore from
            # (state hashes can't be rebuilt; catchup from an archive is
            # the rejoin path for such nodes)
            return False
        row = self.database.execute(
            "SELECT state FROM persistentstate WHERE "
            "statename='bucketlist'").fetchone()
        if row is None:
            return False
        level_hashes = [tuple(p) for p in json.loads(row[0])]
        self.bucket_manager.restore_from_level_hashes(level_hashes)
        hdr = self.ledger_manager.last_closed_header()
        if self.bucket_manager.get_bucket_list_hash() != \
                hdr.bucketListHash:
            raise RuntimeError(
                "restored bucket list does not match the last closed "
                "header's bucketListHash")
        if self.config.BUCKETLIST_DB:
            # build/load every bucket's index NOW (persisted sidecar
            # blooms make this a memmap open; legacy pre-index sidecars
            # upgrade here, at boot) — never as a multi-second stall
            # inside the first point read of the apply path
            self.bucket_manager.bucket_list.ensure_indexes()
        return True

    def _restore_sql_ahead(self) -> None:
        """Reload the sql-ahead overlay's persisted key list (stored
        alongside the bucket state): entries that only ever lived in SQL
        must stay visible to BucketListDB-mode reads across restarts."""
        import json

        row = self.database.execute(
            "SELECT state FROM persistentstate WHERE "
            "statename='sqlahead'").fetchone()
        if row is None:
            return
        self.ledger_manager.root.load_sql_ahead(
            bytes.fromhex(h) for h in json.loads(row[0]))

    def crank(self, block: bool = False) -> int:
        n = self.clock.crank(block)
        while self.scheduler.run_one():
            n += 1
        self.work_scheduler.crank()
        n += self.process_manager.poll()
        if self.tcp_io is not None:
            n += self.tcp_io.poll()
        return n

    def enable_tcp(self) -> None:
        """Real-socket mode: TCP overlay transport + PeerDoor + admin HTTP
        (ref ApplicationImpl start wiring OverlayManager/PeerDoor/
        CommandHandler).  Outbound connections go to KNOWN_PEERS."""
        from ..overlay.manager import OverlayManager
        from ..overlay.tcp_peer import PeerDoor, TCPIOService
        from .http_server import AdminHttpServer

        self.tcp_io = TCPIOService()
        if self.overlay_manager is None:
            self.overlay_manager = OverlayManager(self)
        if self.config.PEER_PORT:
            self.peer_door = PeerDoor(self, self.config.PEER_PORT)
            self.tcp_io.register(self.peer_door.sock,
                                 self.peer_door.on_acceptable)
        if self.config.HTTP_PORT is not None:
            self.http_server = AdminHttpServer(self,
                                               self.config.HTTP_PORT)

    def connect_known_peers(self) -> None:
        from ..overlay.tcp_peer import connect_to

        from ..overlay.peer_manager import OUTBOUND, PREFERRED

        pm = self.overlay_manager.peer_manager
        known = []
        for plist, ptype in ((self.config.PREFERRED_PEERS, PREFERRED),
                             (self.config.KNOWN_PEERS, OUTBOUND)):
            for addr in plist:
                host, _, port = addr.partition(":")
                known.append((host or "127.0.0.1", int(port or 11625),
                              ptype))
        if pm is not None:
            for host, port, ptype in known:
                pm.ensure_exists(host, port, ptype)
            targets = pm.peers_to_try(
                self.config.TARGET_PEER_CONNECTIONS)
        else:
            targets = [(h, p) for h, p, _ in known]
        # never re-dial an address we're already connected (or mid-
        # handshake) to — the periodic tick would otherwise churn a new
        # socket to the same peer every 2s
        connected = set()
        for p in list(self.overlay_manager.authenticated.values()) + \
                list(self.overlay_manager.pending_peers):
            addr = getattr(p, "remote_addr", None)
            if addr is not None:
                connected.add(addr)
        for host, port in targets:
            if (host, port) in connected:
                continue
            peer = connect_to(self, host, port)
            if peer is None and pm is not None:
                pm.on_connect_failure(host, port)

    def _arm_overlay_tick(self) -> None:
        t = self._overlay_tick_timer
        t.cancel()
        t.expires_from_now(2.0)
        t.async_wait(self._overlay_tick)

    def _overlay_tick(self) -> None:
        om = self.overlay_manager
        if om is not None and \
                len(om.authenticated) < self.config.TARGET_PEER_CONNECTIONS:
            self.connect_known_peers()
        self._arm_overlay_tick()

    def stop_node(self) -> None:
        """Tear down THIS node's subsystems without touching the clock —
        the clock may be shared by a whole simulated network (chaos
        crash-restore kills one validator while the rest keep cranking).
        Every timer tagged with this app is swept so no callback fires
        into freed subsystems; on-disk state (DATABASE file + bucket
        store) survives for a restart-from-state rebuild."""
        # vitals first: its gc callback is PROCESS-global (gc.callbacks)
        # and must never keep timing collections for a dead node
        self.vitals.stop()
        # then the close pipeline: its tail worker holds the database
        # and bucket store, both torn down below (drains the in-flight
        # tail; an abandoned tail — the chaos pipeline-window crash —
        # was already discarded via crash_abandon)
        self.ledger_manager.pipeline.shutdown()
        # abort in-flight works (a mid-catchup teardown re-attaches the
        # ledger root) and stop the worker pool before the stores they
        # write to go away below
        self.work_scheduler.shutdown()
        self.process_manager.shutdown()
        self.parallel_apply.shutdown()
        self.bucket_manager.shutdown()
        if self.overlay_manager is not None:
            self.overlay_manager.shutdown()
        if self.peer_door is not None:
            self.peer_door.close()
        if self.http_server is not None:
            self.http_server.close()
        self.clock.cancel_owner(self)
        self.database.close()
        self._started = False

    def graceful_stop(self) -> None:
        self.stop_node()
        self.clock.stop()

    # -- cross-subsystem plumbing ------------------------------------------

    def broadcast_transaction(self, env) -> None:
        if self.overlay_manager is not None:
            self.overlay_manager.broadcast_transaction(env)

    def broadcast_scp_message(self, env) -> None:
        if self.overlay_manager is not None:
            self.overlay_manager.broadcast_scp(env)

    def request_scp_items(self, hashes: List[bytes]) -> None:
        if self.overlay_manager is not None:
            self.overlay_manager.fetch_items(hashes)

    def emit_ledger_close_meta(self, header, tx_set, tx_metas,
                               upgrade_metas) -> None:
        """METADATA_OUTPUT_STREAM equivalent: in-memory ring of
        LedgerCloseMeta (ref LedgerManagerImpl.cpp:738-757)."""
        from ..xdr import xdr_sha256

        meta = T.LedgerCloseMeta.make(0, T.LedgerCloseMetaV0.make(
            ledgerHeader=T.LedgerHeaderHistoryEntry.make(
                hash=xdr_sha256(T.LedgerHeader, header),
                header=header,
                ext=T.LedgerHeaderHistoryEntry.fields[2][1].make(0)),
            txSet=tx_set.to_xdr(),
            txProcessing=tx_metas,
            upgradesProcessing=upgrade_metas,
            scpInfo=[]))
        with self._meta_lock:
            self._meta_stream.append(meta)
            if len(self._meta_stream) > 64:
                self._meta_stream.pop(0)
        # METADATA_OUTPUT_STREAM: append framed XDR to a file for
        # downstream consumers (ref LedgerManagerImpl.cpp:738-757; the
        # reference writes to a configured fd/file)
        path = getattr(self.config, "METADATA_OUTPUT_STREAM", None)
        if path:
            data = T.LedgerCloseMeta.encode(meta)
            with open(path, "ab") as f:
                f.write(len(data).to_bytes(4, "big") + data)
        self.metrics.meter("ledger.close.frame").mark()

    # -- status (ref getJsonInfo / 'info' endpoint) -------------------------

    def get_json_info(self) -> dict:
        lm = self.ledger_manager
        try:
            header = lm.last_closed_header()
            ledger_info = {
                "num": header.ledgerSeq,
                "hash": lm.last_closed_hash().hex(),
                "closeTime": header.scpValue.closeTime,
                "baseFee": header.baseFee,
                "baseReserve": header.baseReserve,
                "maxTxSetSize": header.maxTxSetSize,
                "version": header.ledgerVersion,
            }
        except Exception:
            ledger_info = {}
        return {
            "build": "stellar-core-tpu",
            "ledger": ledger_info,
            "state": ("Synced!" if self._started else "Booting"),
            "network": self.config.NETWORK_PASSPHRASE,
            "protocol_version": self.config.LEDGER_PROTOCOL_VERSION,
            "peers": (self.overlay_manager.connection_count()
                      if self.overlay_manager else 0),
            "pending_txs": self.herder.tx_queue.size(),
            "crypto_backend": self.config.CRYPTO_BACKEND,
        }


