"""close.drain_ms: the mean over the window's ledgers of the close
thread's wait for the close's pipelined tail (the database commit, the
meta with the checkpoint publish, gc), as ``last_close_phases`` records it
(``drain``)."""


def read(ctx):
    rows = [r["drain"] for r in ctx.counters.get("close_phases", [])
            if "drain" in r]
    return sum(rows) / len(rows) if rows else None
