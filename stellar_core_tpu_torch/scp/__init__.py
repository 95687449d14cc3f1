"""Stellar Consensus Protocol — pure, driver-pattern, host-side control
flow with its federated tallies as torch ops (ops/quorum.py) on a device
(ref src/scp — SURVEY.md §2.1).  The port's copy of the JAX package's
``scp``; only ``tally.py`` is rewritten.
"""
from .driver import (  # noqa: F401
    BALLOT_TIMER, NOMINATION_TIMER, SCPDriver, ValidationLevel,
)
from .local_node import LocalNode, make_qset, qset_hash  # noqa: F401
from .scp import SCP  # noqa: F401
from .slot import EnvelopeState, Slot  # noqa: F401
from .ballot import Phase  # noqa: F401
from .tally import TallyMismatch  # noqa: F401
