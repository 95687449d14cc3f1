"""close.unattributed_ms: the mean over the window's ledgers of the part
of ``herder.manual_close`` that none of its recorded phases holds
(``unattributed`` of ``last_close_phases``)."""


def read(ctx):
    rows = [r["unattributed"] for r in ctx.counters.get("close_phases", [])
            if "unattributed" in r]
    return sum(rows) / len(rows) if rows else None
