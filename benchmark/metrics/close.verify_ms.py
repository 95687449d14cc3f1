"""close.verify_ms: the mean over the window's ledgers of the close's
``verify`` phase (``TxSetFrame.prevalidate_signatures``: the set's
signature batch on the device), as ``last_close_phases`` records it."""


def read(ctx):
    rows = [r["verify"] for r in ctx.counters.get("close_phases", [])
            if "verify" in r]
    return sum(rows) / len(rows) if rows else None
