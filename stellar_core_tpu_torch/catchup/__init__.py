"""Catchup subsystem: archive-based rejoin (ref src/catchup —
SURVEY.md §2.8, §3.4)."""
from .catchup_work import (  # noqa: F401
    ApplyBucketsWork, ApplyCheckpointsWork, CatchupConfiguration,
    CatchupWork, DownloadBucketsWork, DownloadBucketWork,
    DownloadTxSetsWork, DownloadVerifyLedgerChainWork,
    GetCheckpointHeadersWork, GetCheckpointTxsWork,
    GetHistoryArchiveStateWork,
)
from .manager import CatchupManager  # noqa: F401
