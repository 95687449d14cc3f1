"""Async work system: finite-state machines for long multi-step tasks
(ref src/work — BasicWork state diagram at src/work/BasicWork.h:15-60).

States: WAITING / RUNNING / SUCCESS / FAILURE / ABORTED, with retry edges.
``Work`` composes children; ``WorkScheduler`` is the app-attached root that
cranks on the main thread; ``BatchWork`` runs a bounded-parallel iterator;
``WorkSequence`` chains works in order.

Since r17 the system is a REAL parallel DAG (ref the reference running
works on ApplicationImpl's worker threads):

- ``WorkerPool`` is a shared thread pool the scheduler owns;
- ``ThreadedWork`` runs its blocking part (``on_io``) on that pool while
  the FSM keeps cranking on the main thread — a ``BatchWork`` over
  ``ThreadedWork`` children therefore keeps ``batch_size`` transfers
  genuinely in flight at once (catchup's archive fetch/verify fan-out);
- failed works retry with exponential clock-based backoff
  (``retry_backoff`` + a ``clock``) instead of hot-spinning the archive;
- ``abort()`` propagates down the DAG: parents drive children to
  ABORTED (cancelling queued pool dispatches) before finishing, and a
  failed ``BatchWork`` aborts its in-flight siblings instead of
  orphaning their futures.
"""
from __future__ import annotations

from enum import Enum
from typing import Callable, Iterator, List, Optional


class State(Enum):
    WAITING = 0
    RUNNING = 1
    SUCCESS = 2
    FAILURE = 3
    ABORTED = 4


class WorkerPool:
    """The scheduler-owned thread pool ThreadedWorks dispatch their
    blocking part to (ref ApplicationImpl's worker io_contexts).  Threads
    spawn lazily, so idle apps (50-validator sims) pay nothing."""

    def __init__(self, max_workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self.max_workers = max(1, int(max_workers))
        self._ex = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="work-pool")

    def submit(self, fn, *args):
        return self._ex.submit(fn, *args)

    def shutdown(self, wait: bool = True) -> None:
        self._ex.shutdown(wait=wait)


class BasicWork:
    """Subclass and implement on_run() -> State (RUNNING to be rescheduled,
    WAITING to block on a child/event, SUCCESS/FAILURE when done).

    ``retry_backoff`` > 0 with a ``clock`` makes failure retries wait
    ``retry_backoff * 2**(retries-1)`` (capped at MAX_RETRY_BACKOFF)
    clock-seconds before re-running — deterministic under VirtualClock,
    wall-clock on live nodes (ref BasicWork::getRetryETA)."""

    RETRY_NEVER = 0
    RETRY_ONCE = 1
    RETRY_A_FEW = 5
    RETRY_FOREVER = 2**31
    MAX_RETRY_BACKOFF = 30.0

    def __init__(self, name: str, max_retries: int = RETRY_A_FEW,
                 clock=None, retry_backoff: float = 0.0):
        self.name = name
        self.max_retries = max_retries
        self.state = State.WAITING
        self.retries = 0
        self.clock = clock
        self.retry_backoff = retry_backoff
        self._retry_at: Optional[float] = None
        self._aborting = False

    # -- subclass surface ---------------------------------------------------

    def on_run(self) -> State:
        raise NotImplementedError

    def on_reset(self) -> None:
        pass

    def on_success(self) -> None:
        pass

    def on_failure_retry(self) -> None:
        pass

    def on_failure_raise(self) -> None:
        pass

    def on_abort(self) -> bool:
        """Return True when abort cleanup is complete."""
        return True

    # -- engine -------------------------------------------------------------

    def start(self) -> None:
        self.state = State.RUNNING
        self.retries = 0
        self._retry_at = None
        self._aborting = False
        self.on_reset()

    def crank(self) -> State:
        if self.state not in (State.RUNNING, State.WAITING):
            return self.state
        if self._aborting:
            if self.on_abort():
                self.state = State.ABORTED
            return self.state
        if self._retry_at is not None:
            if self.clock is not None and \
                    self.clock.now() < self._retry_at:
                return self.state  # backing off before the retry
            self._retry_at = None
        nxt = self.on_run()
        if nxt == State.FAILURE and self.retries < self.max_retries:
            self.retries += 1
            self.on_failure_retry()
            self.on_reset()
            if self.retry_backoff > 0.0 and self.clock is not None:
                self._retry_at = self.clock.now() + min(
                    self.retry_backoff * (2 ** (self.retries - 1)),
                    self.MAX_RETRY_BACKOFF)
            self.state = State.RUNNING
            return self.state
        self.state = nxt
        if nxt == State.SUCCESS:
            self.on_success()
        elif nxt == State.FAILURE:
            self.on_failure_raise()
        return self.state

    def abort(self) -> None:
        if self.state in (State.RUNNING, State.WAITING):
            self._aborting = True

    @property
    def done(self) -> bool:
        return self.state in (State.SUCCESS, State.FAILURE, State.ABORTED)


class ThreadedWork(BasicWork):
    """A work whose blocking part runs on the scheduler's WorkerPool:
    ``on_io()`` executes on a pool thread (file/network I/O, hashing),
    ``on_complete(result)`` back on the cranking thread.  With no pool
    (or a non-thread-safe transport) the work degrades to inline
    execution — same FSM, zero concurrency.

    on_io must not touch main-thread state: everything it reads should be
    captured in __init__, everything it produces returned (the FSM hands
    it to on_complete on the cranking side)."""

    POLL_GRACE = 0.001  # seconds a crank waits on an in-flight future

    def __init__(self, name: str, pool: Optional[WorkerPool] = None,
                 max_retries: int = BasicWork.RETRY_A_FEW,
                 clock=None, retry_backoff: float = 0.0):
        super().__init__(name, max_retries, clock=clock,
                         retry_backoff=retry_backoff)
        self.pool = pool
        self._future = None

    def on_io(self):
        """Worker thread.  Raise to fail the attempt."""
        raise NotImplementedError

    def on_complete(self, result) -> State:
        """Cranking thread, with on_io's return value."""
        return State.SUCCESS

    def on_io_error(self, exc: BaseException) -> None:
        """Cranking thread, before the FAILURE/retry edge."""
        pass

    def on_reset(self) -> None:
        self._future = None

    def on_run(self) -> State:
        if self.pool is None:
            try:
                result = self.on_io()
            except Exception as e:
                self.on_io_error(e)
                return State.FAILURE
            return self.on_complete(result)
        if self._future is None:
            self._future = self.pool.submit(self.on_io)
            return State.RUNNING
        from concurrent.futures import TimeoutError as _FutTimeout

        fut = self._future
        try:
            # a short grace wait instead of a pure poll: tight crank
            # loops make real progress, while sibling futures keep
            # running on the other pool threads in the meantime
            result = fut.result(timeout=self.POLL_GRACE)
        except (_FutTimeout, TimeoutError):
            return State.RUNNING
        except Exception as e:
            self._future = None
            self.on_io_error(e)
            return State.FAILURE
        self._future = None
        # a future that completed leaves the work one decision to make;
        # re-dispatch (multi-round works) happens via RUNNING + next crank
        return self.on_complete(result)

    def on_abort(self) -> bool:
        fut = self._future
        if fut is None:
            return True
        if fut.cancel():
            self._future = None
            return True
        # already running on the pool thread: wait for it to finish
        # (Python threads can't be interrupted); discard the result
        if fut.done():
            self._future = None
            return True
        return False


class Work(BasicWork):
    """A work with children: runs children to completion before itself
    (ref src/work/Work.h).  Subclasses implement do_work() which may add
    children via add_work().  abort() propagates to every child."""

    def __init__(self, name: str, max_retries: int = BasicWork.RETRY_A_FEW,
                 clock=None, retry_backoff: float = 0.0):
        super().__init__(name, max_retries, clock=clock,
                         retry_backoff=retry_backoff)
        self.children: List[BasicWork] = []

    def add_work(self, w: BasicWork) -> BasicWork:
        w.start()
        self.children.append(w)
        return w

    def on_reset(self) -> None:
        self.children.clear()
        self.do_reset()

    def do_reset(self) -> None:
        pass

    def do_work(self) -> State:
        raise NotImplementedError

    def on_run(self) -> State:
        any_failed = False
        all_done = True
        for c in self.children:
            if not c.done:
                c.crank()
            if not c.done:
                all_done = False
            elif c.state in (State.FAILURE, State.ABORTED):
                any_failed = True
        if any_failed:
            # drive the surviving children down before surfacing the
            # failure — in-flight pool futures must not be orphaned
            if not self._abort_children():
                return State.RUNNING
            return State.FAILURE
        if not all_done:
            return State.RUNNING
        return self.do_work()

    def _abort_children(self) -> bool:
        """Abort + crank every non-done child; True when all are done."""
        alive = False
        for c in self.children:
            if not c.done:
                c.abort()
                c.crank()
            if not c.done:
                alive = True
        return not alive

    def on_abort(self) -> bool:
        return self._abort_children()


class WorkSequence(BasicWork):
    """Execute a list of works strictly in order (ref WorkSequence)."""

    def __init__(self, name: str, steps: List[BasicWork]):
        super().__init__(name, max_retries=BasicWork.RETRY_NEVER)
        self.steps = steps
        self._idx = 0

    def on_reset(self) -> None:
        self._idx = 0
        for s in self.steps:
            s.start()

    def on_run(self) -> State:
        while self._idx < len(self.steps):
            cur = self.steps[self._idx]
            if not cur.done:
                cur.crank()
            if not cur.done:
                return State.RUNNING
            if cur.state != State.SUCCESS:
                return State.FAILURE
            self._idx += 1
        return State.SUCCESS

    def on_abort(self) -> bool:
        if self._idx >= len(self.steps):
            return True
        cur = self.steps[self._idx]
        if not cur.done:
            cur.abort()
            cur.crank()
        return cur.done


class BatchWork(Work):
    """Bounded-parallelism iterator (ref src/work/BatchWork.h:19): yields
    works from ``iterator`` keeping at most ``batch_size`` in flight.
    With ThreadedWork children the batch is the archive-transfer fan-out:
    batch_size concurrent downloads, each with its own retry/backoff."""

    def __init__(self, name: str, iterator: Iterator[BasicWork],
                 batch_size: int = 8):
        super().__init__(name, max_retries=BasicWork.RETRY_NEVER)
        self._iter = iterator
        self.batch_size = batch_size
        self._exhausted = False

    def do_reset(self) -> None:
        self._exhausted = False

    def do_work(self) -> State:
        # drop finished children, top up to batch_size
        self.children = [c for c in self.children if not c.done]
        while not self._exhausted and len(self.children) < self.batch_size:
            try:
                nxt = next(self._iter)
            except StopIteration:
                self._exhausted = True
                break
            self.add_work(nxt)
        if self.children:
            return State.RUNNING
        return State.SUCCESS

    def on_run(self) -> State:
        for c in self.children:
            if not c.done:
                c.crank()
        for c in self.children:
            if c.done and c.state in (State.FAILURE, State.ABORTED):
                # one child exhausted its retries: stop spawning and
                # abort the in-flight siblings before failing the batch
                self._exhausted = True
                if not self._abort_children():
                    return State.RUNNING
                return State.FAILURE
        return self.do_work()

    def on_abort(self) -> bool:
        self._exhausted = True
        return self._abort_children()


class WorkWithCallback(BasicWork):
    def __init__(self, name: str, fn: Callable[[], bool]):
        super().__init__(name, max_retries=BasicWork.RETRY_NEVER)
        self.fn = fn

    def on_run(self) -> State:
        return State.SUCCESS if self.fn() else State.FAILURE


class ConditionalWork(BasicWork):
    """Waits for a condition, then runs the wrapped work."""

    def __init__(self, name: str, condition: Callable[[], bool],
                 work: BasicWork):
        super().__init__(name, max_retries=BasicWork.RETRY_NEVER)
        self.condition = condition
        self.work = work
        self._started = False

    def on_run(self) -> State:
        if not self._started:
            if not self.condition():
                return State.RUNNING
            self.work.start()
            self._started = True
        self.work.crank()
        if not self.work.done:
            return State.RUNNING
        return self.work.state

    def on_abort(self) -> bool:
        if not self._started:
            return True
        if not self.work.done:
            self.work.abort()
            self.work.crank()
        return self.work.done


class WorkScheduler(Work):
    """App-attached root work cranked from the main loop
    (ref src/work/WorkScheduler.h:20-48).  Owns the WorkerPool that
    ThreadedWorks under it dispatch to."""

    def __init__(self, clock, worker_pool: Optional[WorkerPool] = None):
        super().__init__("work-scheduler",
                         max_retries=BasicWork.RETRY_NEVER)
        self.clock = clock
        self.worker_pool = worker_pool
        self.state = State.RUNNING

    def do_work(self) -> State:
        return State.RUNNING  # the root never finishes

    def on_run(self) -> State:
        # unlike Work, the root outlives failed children: a failed
        # catchup attempt must not kill the scheduler (or abort its
        # unrelated siblings) — callers observe per-work state instead
        for c in self.children:
            if not c.done:
                c.crank()
        return State.RUNNING

    def schedule(self, w: BasicWork) -> BasicWork:
        return self.add_work(w)

    def shutdown(self) -> None:
        """Abort scheduled works, then stop the pool (node teardown)."""
        for _ in range(1000):
            alive = [c for c in self.children if not c.done]
            if not alive:
                break
            for c in alive:
                c.abort()
                c.crank()
        if self.worker_pool is not None:
            self.worker_pool.shutdown(wait=True)

    def crank_all(self, max_cranks: int = 100_000) -> bool:
        """Crank until all scheduled works are done (test helper); bounded
        so stuck works can't hang the caller."""

        def all_done():
            return all(c.done for c in self.children)

        for _ in range(max_cranks):
            if all_done():
                break
            self.crank()
            self.clock.crank(block=False)
            if all(c.state == State.WAITING for c in self.children
                   if not c.done):
                break  # blocked on external events with none pending
        return all_done()
