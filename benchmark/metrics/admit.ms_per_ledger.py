"""admit.ms_per_ledger: ms a ledger in herder admission (decoding each
envelope and ``herder.recv_transaction``: the queue's checks and the
host's signature verify), from the benchmark's ``admit`` spans."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.span_seconds("admit") * 1e3 / len(ctx.steps)
