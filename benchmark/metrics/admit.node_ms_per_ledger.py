"""admit.node_ms_per_ledger: the mean over the window's ledgers of the
node's own admission (``admit`` of ``last_close_phases``: every
``herder.recv_transaction`` since the previous close, the queue's checks
and the host's signature verify), without the benchmark's decode of each
envelope's wire bytes that ``admit.ms_per_ledger`` holds too."""


def read(ctx):
    rows = [r["admit"] for r in ctx.counters.get("close_phases", [])
            if "admit" in r]
    return sum(rows) / len(rows) if rows else None
