"""close.herder_ms: the mean over the window's ledgers of the herder's
part of a manual close, as ``last_close_phases`` records it: the tx set's
build (``trigger``), SCP from nomination to externalization (``scp``),
the write of the slot's SCP history (``scp_persist``) and the housekeeping
after the close (``ledger_closed``)."""

KEYS = ("trigger", "scp", "scp_persist", "ledger_closed")


def read(ctx):
    rows = [sum(r[k] for k in KEYS)
            for r in ctx.counters.get("close_phases", [])
            if all(k in r for k in KEYS)]
    return sum(rows) / len(rows) if rows else None
