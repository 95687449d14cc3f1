"""CatchupManager: buffers externalized-but-unappliable ledgers and runs
archive catchup ASYNCHRONOUSLY while the network keeps closing
(ref CatchupManagerImpl: maybeQueueHistoryCheckpoint's twin on the
consuming side — trimAndQueue / tryApplySyncingLedgers / startCatchup).

The manager never blocks the caller: catchup runs as a CatchupWork on
the app's WorkScheduler, driven by a VirtualTimer tick (owner-tagged,
swept by Application.stop_node), so a cold node trailing 1000+ ledgers
keeps buffering live closes WHILE buckets download/apply.  When the
work completes, the buffer drains contiguously on top of the restored
state and the node is synced."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..work.work import State
from .catchup_work import CatchupConfiguration, CatchupWork


class CatchupManager:
    # how many ledgers behind before archive catchup kicks in (the
    # reference triggers once the gap can't be bridged by buffering);
    # overridable via config CATCHUP_TRIGGER_GAP
    TRIGGER_GAP = 2

    # virtual seconds between work-cranking ticks while catchup runs
    TICK_SECONDS = 0.02
    # FSM cranks per tick (bounds main-loop time per tick; downloads
    # progress on the worker pool regardless)
    CRANKS_PER_TICK = 64

    def __init__(self, app):
        self.app = app
        self.buffered: Dict[int, Tuple[object, object]] = {}
        self.catchup_runs = 0
        self.catchup_failures = 0
        self.current_work: Optional[CatchupWork] = None
        self._timer = None

    # -- knobs --------------------------------------------------------------

    @property
    def trigger_gap(self) -> int:
        return getattr(self.app.config, "CATCHUP_TRIGGER_GAP",
                       self.TRIGGER_GAP)

    # -- buffering (ref processLedger) --------------------------------------

    def buffer_externalized(self, seq, tx_set, sv) -> None:
        self.buffered[seq] = (tx_set, sv)
        self._try_drain()
        self._maybe_start_catchup()
        self.app.metrics.gauge("catchup.buffered-ledgers").set(
            len(self.buffered))

    def _try_drain(self) -> None:
        from ..ledger.ledger_manager import LedgerCloseData

        lm = self.app.ledger_manager
        while lm.last_closed_seq() + 1 in self.buffered:
            s = lm.last_closed_seq() + 1
            tx_set, sv = self.buffered.pop(s)
            lm.close_ledger(LedgerCloseData(s, tx_set, sv))
            self.app.herder.ledger_closed(s)
        # drop anything at or below the LCL
        for s in [s for s in self.buffered if s <= lm.last_closed_seq()]:
            del self.buffered[s]
        self.app.metrics.gauge("catchup.buffered-ledgers").set(
            len(self.buffered))

    # -- async catchup (ref startCatchup) -----------------------------------

    def _maybe_start_catchup(self) -> None:
        app = self.app
        if self.current_work is not None or not self.buffered:
            return
        hm = app.history_manager
        if not hm.archives:
            return
        lm = app.ledger_manager
        lcl = lm.last_closed_seq()
        newest = max(self.buffered)
        if newest - lcl <= self.trigger_gap:
            return
        target_cp = hm.latest_checkpoint_at_or_before(newest)
        if target_cp <= lcl:
            return  # nothing an archive can add; keep buffering
        # trust anchor: the buffered externalized tx set at cp+1 carries
        # previousLedgerHash == the header hash of cp, attested by live
        # consensus — without it the archive's chain would only be checked
        # for self-consistency, and draining cp+1.. couldn't proceed
        # contiguously anyway (ref the reference anchoring catchup at an
        # externalized hash)
        anchor = self.buffered.get(target_cp + 1)
        if anchor is None:
            return  # wait for the buffer (or the next checkpoint) to align
        trusted_hash = anchor[0].previous_ledger_hash
        mode = (CatchupConfiguration.COMPLETE
                if app.config.CATCHUP_COMPLETE
                else CatchupConfiguration.MINIMAL)
        with app.tracer.span("catchup.trigger", target=target_cp,
                             lcl=lcl, mode=mode,
                             buffered=len(self.buffered)):
            work = CatchupWork(
                app, hm.archives[0],
                CatchupConfiguration(target_cp, mode),
                trusted_hash=trusted_hash,
                retry_backoff=getattr(app.config,
                                      "CATCHUP_RETRY_BACKOFF", 0.1))
            self.current_work = app.work_scheduler.schedule(work)
        app.metrics.counter("catchup.started").inc()
        self._arm_tick()

    def _arm_tick(self) -> None:
        if self._timer is None:
            from ..utils.clock import VirtualTimer

            self._timer = VirtualTimer(self.app.clock, owner=self.app)
        t = self._timer
        t.cancel()
        t.expires_from_now(self.TICK_SECONDS)
        t.async_wait(self._tick)

    def _tick(self) -> None:
        w = self.current_work
        if w is None:
            return
        for _ in range(self.CRANKS_PER_TICK):
            if w.done:
                break
            w.crank()
        if not w.done:
            self._arm_tick()
            return
        self.current_work = None
        if w.state == State.SUCCESS:
            self.catchup_runs += 1
            self.app.metrics.counter("catchup.runs.success").inc()
        else:
            self.catchup_failures += 1
            self.app.metrics.counter("catchup.runs.failure").inc()
        with self.app.tracer.span("catchup.drain",
                                  buffered=len(self.buffered),
                                  outcome=w.state.name):
            self._try_drain()
        # still trailing (a long apply let the network run ahead, or the
        # attempt failed and the archive has advanced)? go again
        self._maybe_start_catchup()

    # -- status (catchup-status HTTP endpoint / bench) ----------------------

    def status(self) -> dict:
        lm = self.app.ledger_manager
        w = self.current_work
        out = {
            "state": "catching-up" if w is not None else "idle",
            "lcl": lm.last_closed_seq(),
            "buffered": len(self.buffered),
            "newest-buffered": max(self.buffered) if self.buffered else 0,
            "runs": self.catchup_runs,
            "failures": self.catchup_failures,
        }
        if w is not None:
            out["phase"] = w.phase
            out["mode"] = w.config.mode
            out["target"] = w.target_checkpoint
        return out
