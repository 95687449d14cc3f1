"""History subsystem: checkpoint publishing to archives + the archive
format (ref src/history — SURVEY.md §2.8)."""
from .archive import (  # noqa: F401
    HistoryArchive, HistoryArchiveState, checkpoint_name,
)
from .manager import HistoryManager, PublishWork  # noqa: F401
