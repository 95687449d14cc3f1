"""verifies_per_s: the signatures of the set validated in the window's
whole steps over those steps' seconds, decoding included."""


def read(ctx):
    per_step = ctx.counters.get("signatures_per_step")
    if not ctx.steps or not per_step:
        return None
    return per_step * len(ctx.steps) / ctx.window_s
