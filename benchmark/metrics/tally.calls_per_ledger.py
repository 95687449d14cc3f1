"""tally.calls_per_ledger: the tally engine's federated accept and ratify
calls a network ledger, over all validators."""


def read(ctx):
    if "tally_calls" not in ctx.counters or not ctx.steps:
        return None
    return ctx.counters["tally_calls"] / len(ctx.steps)
