"""Herder subsystem (ref src/herder — SURVEY.md §2.2), as far as the port
goes: the quorum-intersection checker with its native, numpy and device
tiers, and the quorum tracker that feeds it.  ``Herder``, the tx set and
the tx queue are not ported yet."""
from .quorum_intersection import (  # noqa: F401
    InterruptFlag, QuorumIntersectionResult, check_quorum_intersection,
)
from .quorum_tracker import QuorumTracker  # noqa: F401
