"""ledger_ms: the window's wall time over the ledgers completed in it (a
ledger: the admission of its envelopes and its close)."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.window_s * 1e3 / len(ctx.steps)
