"""net_ledger_ms: the window's wall time over the ledgers that every
validator of the network externalized in it (a ledger: its payments'
submission and flooding, then consensus until every node has closed)."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.window_s * 1e3 / len(ctx.steps)
