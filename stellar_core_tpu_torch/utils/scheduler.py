"""Fair multi-queue action scheduler with latency-based load shedding
(ref src/util/Scheduler.h:24-140).

Actions are enqueued into named queues; dispatch round-robins by accumulated
runtime (the queue that has consumed the least runs next).  Queues whose
oldest action exceeds the latency window shed DROPPABLE actions.
"""
from __future__ import annotations

import time
from collections import deque
from enum import Enum
from typing import Callable, Deque, Dict, Optional, Tuple


class ActionType(Enum):
    NORMAL = 0
    DROPPABLE = 1


class _Queue:
    __slots__ = ("name", "actions", "total_service_time")

    def __init__(self, name: str):
        self.name = name
        self.actions: Deque[Tuple[float, ActionType, Callable]] = deque()
        self.total_service_time = 0.0


class Scheduler:
    def __init__(self, clock, latency_window: float = 5.0):
        self.clock = clock
        self.latency_window = latency_window
        self.queues: Dict[str, _Queue] = {}
        self.stats_dropped = 0
        self.stats_ran = 0

    def enqueue(self, queue_name: str, action: Callable[[], None],
                action_type: ActionType = ActionType.NORMAL) -> None:
        q = self.queues.get(queue_name)
        if q is None:
            q = self.queues[queue_name] = _Queue(queue_name)
        q.actions.append((self.clock.now(), action_type, action))

    def _shed(self, q: _Queue) -> None:
        now = self.clock.now()
        kept: Deque = deque()
        while q.actions:
            ts, typ, act = q.actions.popleft()
            if (typ == ActionType.DROPPABLE
                    and now - ts > self.latency_window):
                self.stats_dropped += 1
            else:
                kept.append((ts, typ, act))
        q.actions = kept

    def run_one(self) -> bool:
        """Run the next action from the least-served non-empty queue."""
        best: Optional[_Queue] = None
        for q in self.queues.values():
            self._shed(q)
            if q.actions and (best is None
                              or q.total_service_time
                              < best.total_service_time):
                best = q
        if best is None:
            return False
        _, _, action = best.actions.popleft()
        t0 = time.perf_counter()
        try:
            action()
        finally:
            best.total_service_time += time.perf_counter() - t0
            self.stats_ran += 1
        return True

    def size(self) -> int:
        return sum(len(q.actions) for q in self.queues.values())
