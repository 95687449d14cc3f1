"""Invariant checkers (ref src/invariant — SURVEY.md §2.13)."""
from .manager import (  # noqa: F401
    ConservationOfLumens, Invariant, InvariantDoesNotHold, InvariantManager,
    LedgerEntryIsValid,
)
