"""close.apply_ms: the mean over the window's ledgers of the close's
``apply`` phase, as the ledger manager records it
(``last_close_phases``)."""


def read(ctx):
    rows = [r["apply"] for r in ctx.counters.get("close_phases", [])
            if "apply" in r]
    return sum(rows) / len(rows) if rows else None
