"""Infrastructure: clock, scheduler, metrics, logging
(ref src/util — SURVEY.md §2.15)."""
from .clock import ClockMode, VirtualClock, VirtualTimer  # noqa: F401
from .metrics import MetricsRegistry  # noqa: F401
from .scheduler import ActionType, Scheduler  # noqa: F401
