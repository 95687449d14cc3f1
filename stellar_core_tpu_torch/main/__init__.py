"""App container + config (ref src/main — SURVEY.md §2.10)."""
from .application import Application  # noqa: F401
from .config import Config, test_config  # noqa: F401
