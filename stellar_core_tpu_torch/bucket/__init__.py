"""Bucket list / state commitment (ref src/bucket — SURVEY.md §2.7)."""
from .bucket_list import (  # noqa: F401
    Bucket, BucketList, BucketManager, level_should_spill, level_size,
)
