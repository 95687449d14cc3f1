"""Ledger subsystem (ref src/ledger — SURVEY.md §2.4)."""
from .ledger_txn import (  # noqa: F401
    AbstractLedgerTxn, LedgerTxn, LedgerTxnError, LedgerTxnRoot,
    entry_to_key, key_bytes, open_database,
)
