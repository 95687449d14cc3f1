"""tally.ms_per_ledger: ms a network ledger inside the tally engine's
federated accept and ratify calls (``scp/tally.py``: the vote rows, the
device ops of ``ops/quorum.py`` and the readback), summed over the
validators, from the benchmark's wrapper of those calls."""


def read(ctx):
    if "tally_s" not in ctx.counters or not ctx.steps:
        return None
    return ctx.counters["tally_s"] * 1e3 / len(ctx.steps)
