"""The device's idle share of the traced window's steps: 100 less the
share in which a kernel or a copy ran, from the profiler's trace."""
from benchmark.trace import idle_pct


def read(ctx):
    return idle_pct(ctx)
