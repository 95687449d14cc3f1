"""Process subsystem (ref src/process — SURVEY.md §2.12)."""
from .process_manager import ProcessManager, RunCommandWork  # noqa: F401
