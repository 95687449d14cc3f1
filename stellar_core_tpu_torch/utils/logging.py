"""Partitioned logging (ref src/util/Logging.h + LogPartitions.def).

15 partitions with independently settable levels, runtime-adjustable via
the admin ``ll`` endpoint like the reference (ref CommandHandler.cpp:113).
Built over the stdlib logging module.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

PARTITIONS = [
    "Fs", "SCP", "Bucket", "Database", "History", "Process", "Ledger",
    "Overlay", "Herder", "Tx", "LoadGen", "Work", "Invariant", "Perf",
    "Default",
]

_loggers: Dict[str, logging.Logger] = {}


def get_logger(partition: str) -> logging.Logger:
    if partition not in PARTITIONS:
        partition = "Default"
    lg = _loggers.get(partition)
    if lg is None:
        lg = logging.getLogger(f"stellar_core_tpu_torch.{partition}")
        _loggers[partition] = lg
    return lg


def set_log_level(level: str, partition: Optional[str] = None) -> None:
    """Set one partition's level, or all when partition is None.
    Raises ValueError on an unknown level or partition — the runtime
    ``ll`` endpoint must not silently retarget the Default partition."""
    lvl = getattr(logging, level.upper(), None)
    if not isinstance(lvl, int):
        raise ValueError(f"unknown log level {level!r}")
    if partition is not None and partition not in PARTITIONS:
        raise ValueError(f"unknown log partition {partition!r}")
    targets = [partition] if partition else PARTITIONS
    for p in targets:
        get_logger(p).setLevel(lvl)


def get_log_levels() -> Dict[str, str]:
    return {
        p: logging.getLevelName(get_logger(p).getEffectiveLevel())
        for p in PARTITIONS
    }


def init(level: str = "INFO") -> None:
    logging.basicConfig(
        format="%(asctime)s %(name)s [%(levelname)s] %(message)s")
    set_log_level(level)


class LogSlowExecution:
    """Scope timer that logs when a step exceeds a threshold
    (ref src/util/LogSlowExecution.h — used around closeLedger,
    LedgerManagerImpl.cpp:673)."""

    def __init__(self, name: str, threshold_seconds: float = 1.0,
                 partition: str = "Perf"):
        import time as _time

        self.name = name
        self.threshold = threshold_seconds
        self.partition = partition
        self._time = _time
        self._t0 = None

    def __enter__(self):
        self._t0 = self._time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = self._time.perf_counter() - self._t0
        if dt > self.threshold:
            get_logger(self.partition).warning(
                "slow execution: %s took %.3fs (threshold %.3fs)",
                self.name, dt, self.threshold)
        return False
