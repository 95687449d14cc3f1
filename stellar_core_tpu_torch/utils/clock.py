"""VirtualClock + VirtualTimer: the event loop of every node.

Two modes like the reference (ref src/util/Timer.h:64-223):
- REAL_TIME: now() is wall-clock; crank() dispatches due work.
- VIRTUAL_TIME: now() only advances when cranked and jumps straight to the
  next scheduled event — whole multi-node networks simulate deterministically
  at accelerated time in one process (ref docs/architecture.md:33-36).

The host event loop stays single-threaded by design (ref
docs/architecture.md:24-27; SURVEY.md §2.17 P1): consensus/state mutation
all happens on the crank thread, while TPU work is dispatched
asynchronously through jax and joined at batch boundaries.
"""
from __future__ import annotations

import heapq
import itertools
import time as _time
from enum import Enum
from typing import Callable, List, Optional, Tuple


class ClockMode(Enum):
    REAL_TIME = 0
    VIRTUAL_TIME = 1


class CrankProfiler:
    """Attributes the real wall time spent inside ``VirtualClock.crank``
    dispatch to subsystem buckets, keyed by the callback's defining class
    (the first ``__qualname__`` segment — closures armed inside a method
    still carry the class).  Purely observational: it wraps each dispatch
    in perf_counter stamps and never touches virtual time, so same-seed
    sim runs stay bit-identical with the profiler on or off.

    The ``crank`` bucket is the crank loop's own overhead (heap pops,
    deadline scans, REAL_TIME idle sleeps) — whole-crank wall minus the
    dispatched-callback wall — so the report's ``attributed_pct`` covers
    everything spent inside crank(); the remainder of measured wall is
    time outside the event loop (test harness, bench bookkeeping).
    """

    # first __qualname__ segment -> bucket; unlisted classes and
    # module-level functions fall into "other"
    _CLASS_BUCKETS = {
        # quorum-slice evaluation + consensus state machines
        "Herder": "consensus", "HerderSCPDriver": "consensus",
        "PendingEnvelopes": "consensus", "SCP": "consensus",
        "Slot": "consensus", "BallotProtocol": "consensus",
        "NominationProtocol": "consensus", "LocalNode": "consensus",
        "TallyEngine": "consensus", "QuorumTracker": "consensus",
        "QuorumHealthMonitor": "consensus",
        "TransactionQueue": "consensus",
        # per-node close phases + state
        "LedgerManager": "ledger", "ClosePipeline": "ledger",
        "LedgerCloseData": "ledger", "BucketManager": "ledger",
        "BucketList": "ledger", "Bucket": "ledger",
        "HistoryManager": "ledger", "PublishWork": "ledger",
        # overlay delivery
        "OverlayManager": "overlay", "Peer": "overlay",
        "LoopbackPeer": "overlay", "TCPPeer": "overlay",
        "PeerDoor": "overlay", "TCPIOService": "overlay",
        "Floodgate": "overlay", "SurveyManager": "overlay",
        "PeerManager": "overlay", "AdminHttpServer": "overlay",
        # chaos bookkeeping
        "ChaosEngine": "chaos", "LinkChaos": "chaos",
        "LinkPolicy": "chaos",
        # rig machinery
        "LoadGenerator": "loadgen",
        "VitalsSampler": "vitals",
        "Simulation": "sim",
        "Application": "app",
    }

    def __init__(self):
        self.buckets = {}  # bucket -> dispatched wall seconds
        self.events = {}   # bucket -> dispatch count
        self.crank_wall_s = 0.0
        self.cranks = 0
        self._t0 = _time.perf_counter()
        self._qn_cache = {}  # qualname head -> bucket
        # wall charged to nested scopes inside the current dispatch —
        # subtracted from the enclosing charge so every wall second
        # lands in exactly one bucket (self-time attribution)
        self._nested = 0.0

    def _bucket_of(self, cb) -> str:
        qn = getattr(cb, "__qualname__", None)
        if qn is None:  # functools.partial etc.
            qn = getattr(getattr(cb, "func", None), "__qualname__", "")
        head = qn.split(".", 1)[0]
        b = self._qn_cache.get(head)
        if b is None:
            b = self._qn_cache[head] = self._CLASS_BUCKETS.get(
                head, "other")
        return b

    def _charge_bucket(self, b: str, dt: float) -> None:
        self.buckets[b] = self.buckets.get(b, 0.0) + dt
        self.events[b] = self.events.get(b, 0) + 1

    def run(self, cb: Callable[[], None]) -> None:
        saved, self._nested = self._nested, 0.0
        t0 = _time.perf_counter()
        try:
            cb()
        finally:
            dt = _time.perf_counter() - t0
            self._charge_bucket(self._bucket_of(cb),
                                max(0.0, dt - self._nested))
            self._nested = saved

    def run_timer(self, timer: "VirtualTimer") -> None:
        cb = timer._cb  # snapshot: _fire() clears it
        saved, self._nested = self._nested, 0.0
        t0 = _time.perf_counter()
        try:
            timer._fire()
        finally:
            dt = _time.perf_counter() - t0
            self._charge_bucket(self._bucket_of(cb),
                                max(0.0, dt - self._nested))
            self._nested = saved

    # -- nested scopes (subsystem hooks) ------------------------------------
    # Deep subsystems (ledger close, SCP envelope processing) run INSIDE
    # overlay delivery callbacks, so entry-point attribution alone would
    # lump them into "overlay".  scope_begin/scope_end carve their wall
    # out of the enclosing dispatch; hook sites cost one is-None check
    # when profiling is off and never read the wallclock themselves.

    def scope_begin(self, bucket: str) -> tuple:
        tok = (bucket, _time.perf_counter(), self._nested)
        self._nested = 0.0
        return tok

    def scope_end(self, tok: tuple) -> None:
        bucket, t0, saved = tok
        dt = _time.perf_counter() - t0
        self._charge_bucket(bucket, max(0.0, dt - self._nested))
        self._nested = saved + dt

    def note_crank(self, dt: float) -> None:
        self.crank_wall_s += dt
        self.cranks += 1

    def report(self, virtual_elapsed: Optional[float] = None) -> dict:
        measured = _time.perf_counter() - self._t0
        dispatched = sum(self.buckets.values())
        buckets = {k: round(v, 6) for k, v in sorted(self.buckets.items())}
        buckets["crank"] = round(max(0.0, self.crank_wall_s - dispatched),
                                 6)
        attributed = dispatched + buckets["crank"]
        doc = {
            "buckets_s": buckets,
            "events": {k: v for k, v in sorted(self.events.items())},
            "cranks": self.cranks,
            "measured_wall_s": round(measured, 6),
            "attributed_wall_s": round(attributed, 6),
            "attributed_pct": round(100.0 * attributed / measured, 2)
            if measured > 0 else 0.0,
        }
        if virtual_elapsed is not None and virtual_elapsed > 0:
            doc["virtual_s"] = round(virtual_elapsed, 6)
            doc["wall_per_virtual_s"] = round(measured / virtual_elapsed, 6)
        return doc


class VirtualClock:
    def __init__(self, mode: ClockMode = ClockMode.VIRTUAL_TIME):
        self.mode = mode
        self._virtual_now = 0.0
        self._timers: List[Tuple[float, int, "VirtualTimer"]] = []
        self._seq = itertools.count()
        self._actions: List[Callable[[], None]] = []
        self._stopped = False
        # crank wall-attribution hook (CrankProfiler); None keeps the
        # dispatch loop at one is-None check per event
        self.profiler: Optional[CrankProfiler] = None

    # -- time --------------------------------------------------------------

    def now(self) -> float:
        if self.mode == ClockMode.REAL_TIME:
            return _time.monotonic()
        return self._virtual_now

    def system_now(self) -> float:
        """Wall-clock (unix) time; virtual mode derives it from the virtual
        offset so close times stay deterministic in simulation."""
        if self.mode == ClockMode.REAL_TIME:
            return _time.time()
        return self._virtual_now

    def set_current_virtual_time(self, t: float) -> None:
        assert self.mode == ClockMode.VIRTUAL_TIME
        assert t >= self._virtual_now
        self._virtual_now = t

    # -- scheduling --------------------------------------------------------

    def post_action(self, action: Callable[[], None]) -> None:
        """Queue work for the next crank (ref postOnMainThread)."""
        self._actions.append(action)

    def _enqueue_timer(self, deadline: float, timer: "VirtualTimer",
                       gen: int) -> None:
        heapq.heappush(self._timers, (deadline, next(self._seq), timer, gen))

    def next_deadline(self) -> Optional[float]:
        while self._timers and not self._timers[0][2]._live(
                self._timers[0][3]):
            heapq.heappop(self._timers)
        return self._timers[0][0] if self._timers else None

    # -- crank -------------------------------------------------------------

    def crank(self, block: bool = False) -> int:
        """Dispatch queued actions + due timers; returns #events dispatched.

        VIRTUAL_TIME: if nothing is due and ``block``, jump time to the next
        deadline.  REAL_TIME: if nothing is due and ``block``, sleep until
        the next deadline.
        """
        if self._stopped:
            return 0
        prof = self.profiler
        t_start = _time.perf_counter() if prof is not None else 0.0
        progress = 0

        actions, self._actions = self._actions, []
        for a in actions:
            if prof is None:
                a()
            else:
                prof.run(a)
            progress += 1

        while True:
            nd = self.next_deadline()
            if nd is None:
                break
            if nd > self.now():
                if progress == 0 and block:
                    if self.mode == ClockMode.VIRTUAL_TIME:
                        self._virtual_now = nd
                    else:
                        _time.sleep(nd - self.now())
                    continue
                break
            _, _, timer, gen = heapq.heappop(self._timers)
            if not timer._live(gen):
                continue
            if prof is None:
                timer._fire()
            else:
                prof.run_timer(timer)
            progress += 1
            # actions posted by timer callbacks run this crank too
            actions, self._actions = self._actions, []
            for a in actions:
                if prof is None:
                    a()
                else:
                    prof.run(a)
                progress += 1
        if prof is not None:
            prof.note_crank(_time.perf_counter() - t_start)
        return progress

    def crank_until(self, pred: Callable[[], bool],
                    timeout: float = 100.0) -> bool:
        """Crank until pred() or the (virtual/real) deadline passes —
        the test-harness workhorse (ref Simulation::crankUntil)."""
        deadline = self.now() + timeout
        while self.now() <= deadline:
            if pred():
                return True
            if self.crank(block=True) == 0 and self.next_deadline() is None:
                # fully idle: nothing will ever change
                return pred()
        return pred()

    def cancel_owner(self, owner: object) -> int:
        """Cancel every armed timer tagged with ``owner`` — the teardown
        path for one node on a SHARED clock (chaos crash-restore): a dead
        Application's timers must never fire into freed subsystems while
        the rest of the simulated network keeps cranking.  Returns the
        number of timers cancelled."""
        n = 0
        for entry in list(self._timers):
            timer = entry[2]
            if timer.owner is owner and timer._live(entry[3]):
                timer.cancel()
                n += 1
        return n

    def stop(self) -> None:
        self._stopped = True


class VirtualTimer:
    """One-shot timer owned by a subsystem (ref VirtualTimer).

    expires_from_now/expires_at + async_wait(cb, on_cancel=None); cancel()
    invokes the cancel handler like asio's operation_aborted path.
    Cancel-and-rearm is safe: heap entries carry the arming generation, so
    a stale entry from before a cancel() can never fire a later callback.

    ``owner`` tags the timer with the object (typically the Application)
    whose lifetime bounds it, so ``VirtualClock.cancel_owner`` can sweep
    every timer of one node off a shared simulation clock.
    """

    def __init__(self, clock: VirtualClock, owner: object = None):
        self.clock = clock
        self.owner = owner
        self.cancelled = False
        self._cb: Optional[Callable[[], None]] = None
        self._on_cancel: Optional[Callable[[], None]] = None
        self._armed = False
        self._gen = 0  # bumped on every arm/cancel; heap entries snapshot it

    def expires_from_now(self, delay: float) -> None:
        self._deadline = self.clock.now() + delay

    def expires_at(self, deadline: float) -> None:
        self._deadline = deadline

    def async_wait(self, cb: Callable[[], None],
                   on_cancel: Optional[Callable[[], None]] = None) -> None:
        assert not self._armed, "timer already armed"
        self.cancelled = False
        self._cb = cb
        self._on_cancel = on_cancel
        self._armed = True
        self._gen += 1
        self.clock._enqueue_timer(self._deadline, self, self._gen)

    def cancel(self) -> None:
        if self._armed and not self.cancelled:
            self.cancelled = True
            self._armed = False
            self._gen += 1  # invalidate the outstanding heap entry
            if self._on_cancel is not None:
                cb = self._on_cancel
                self._on_cancel = None
                self.clock.post_action(cb)

    def _live(self, gen: int) -> bool:
        return not self.cancelled and self._armed and gen == self._gen

    def _fire(self) -> None:
        self._armed = False
        cb = self._cb
        self._cb = None
        if cb is not None:
            cb()
