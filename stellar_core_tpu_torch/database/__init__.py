"""Database subsystem (ref src/database — SURVEY.md §2.11)."""
from .database import Database  # noqa: F401
