"""scp.consensus_ms_per_ledger: ms a network ledger in the ``consensus``
bucket of the shared clock's ``CrankProfiler`` (herder, SCP, the tally
engine and the tx queue, self time), summed over the validators."""


def read(ctx):
    report = ctx.counters.get("crank_report")
    if report is None or not ctx.steps:
        return None
    return report["buckets_s"].get("consensus", 0.0) * 1e3 / len(ctx.steps)
