"""state.read_ms_per_ledger: the mean over the window's ledgers of the ms
of the reads that ``state.reads_per_ledger`` counts: ``LedgerTxnRoot.get``
and ``prefetch`` past the entry cache, and the close pipeline's prefetch
worker's walk of the bucket tier, on its own thread, in admission and in
the manual close (``admit_state_read_ms`` + ``close_state_read_ms`` of
``last_close_phases``).  A program whose record lacks them reports
nothing."""


def read(ctx):
    rows = [r["admit_state_read_ms"] + r["close_state_read_ms"]
            for r in ctx.counters.get("close_phases", [])
            if "admit_state_read_ms" in r and "close_state_read_ms" in r]
    return sum(rows) / len(rows) if rows else None
