"""Herder subsystem (ref src/herder — SURVEY.md §2.2): the JAX package's
exports, plus the quorum-intersection checker with its native, numpy and
device tiers and the quorum tracker that feeds it."""
from .herder import Herder, HerderSCPDriver, HerderState  # noqa: F401
from .quorum_intersection import (  # noqa: F401
    InterruptFlag, QuorumIntersectionResult, check_quorum_intersection,
)
from .quorum_tracker import QuorumTracker  # noqa: F401
from .tx_queue import TransactionQueue  # noqa: F401
from .tx_set import TxSetFrame, surge_pricing_filter  # noqa: F401
