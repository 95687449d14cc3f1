"""txset.decode_ms: ms a step decoding the set's wire bytes and building
its frames (``TransactionSet.decode``, ``TxSetFrame.make_from_wire``),
from the benchmark's ``decode`` spans."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.span_seconds("decode") * 1e3 / len(ctx.steps)
