"""bucket.merge_ms_per_ledger: the mean over the window's ledgers of the
ms of the bucket list's background merges that finished since the
previous close, on the merge workers, which share the host with the
close (``merge_ms`` of ``last_close_phases``).  A program whose record
lacks it reports nothing."""


def read(ctx):
    rows = [r["merge_ms"] for r in ctx.counters.get("close_phases", [])
            if "merge_ms" in r]
    return sum(rows) / len(rows) if rows else None
