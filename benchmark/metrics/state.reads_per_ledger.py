"""state.reads_per_ledger: the mean over the window's ledgers of the keys
read from the ledger state's bucket tier (BucketListDB's bloom filters,
indexes and bucket files): those ``LedgerTxnRoot.get`` and ``prefetch``
found missing from the entry cache and the overlays, and every key the
close pipeline's prefetch worker walked, in admission and in the manual
close (``admit_state_reads`` + ``close_state_reads`` of
``last_close_phases``).  A program whose record lacks them reports
nothing."""


def read(ctx):
    rows = [r["admit_state_reads"] + r["close_state_reads"]
            for r in ctx.counters.get("close_phases", [])
            if "admit_state_reads" in r and "close_state_reads" in r]
    return sum(rows) / len(rows) if rows else None
