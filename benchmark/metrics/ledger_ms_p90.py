"""ledger_ms_p90: the 90th percentile (nearest rank) of the window's
per-ledger wall times, admission and close together."""
import math


def read(ctx):
    if not ctx.steps:
        return None
    ms = sorted((b - a) / 1e6 for a, b in ctx.steps)
    return ms[math.ceil(0.9 * len(ms)) - 1]
