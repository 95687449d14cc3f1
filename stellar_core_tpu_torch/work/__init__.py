"""Async work FSM framework (ref src/work — SURVEY.md §2.9)."""
from .work import (  # noqa: F401
    BasicWork, BatchWork, ConditionalWork, State, Work, WorkScheduler,
    WorkSequence, WorkWithCallback,
)
