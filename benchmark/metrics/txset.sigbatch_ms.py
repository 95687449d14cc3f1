"""txset.sigbatch_ms: ms a step in the verify seam
(``prevalidate_signatures``: collecting the batch, padding, the copy, the
launch and the readback), from the benchmark's ``prevalidate`` spans."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.span_seconds("prevalidate") * 1e3 / len(ctx.steps)
