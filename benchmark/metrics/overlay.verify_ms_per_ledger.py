"""overlay.verify_ms_per_ledger: ms a network ledger in the overlay's
SCP envelope batches (``OverlayManager._verify_triples``: packing, the
copy, the launch and the readback), summed over the validators."""


def read(ctx):
    if "overlay_verify_s" not in ctx.counters or not ctx.steps:
        return None
    return ctx.counters["overlay_verify_s"] * 1e3 / len(ctx.steps)
