"""verify_kernel.roofline_pct: the verify kernel's share of its bound on
a step: the least time the H100 could take for the work of the set's
real signatures (padding rows not counted; ``reference/verify_work.py``
at the peaks of ``peaks.json``), over the kernel's device time a step in
the trace."""
from benchmark.reference import ed25519 as ref
from benchmark.reference.verify_work import bound_ms_verify

KERNEL = "ed25519_verify_kernel"


def read(ctx):
    s = ctx.trace_summary
    rows = ctx.counters.get("verify_rows")
    if s is None or rows is None or not ctx.steps:
        return None
    kernel_ns = sum(v for k, v in s["ops_ns"].items() if k.startswith(KERNEL))
    if kernel_ns <= 0:
        return None
    bound_ms, _, _ = bound_ms_verify(ref, *rows)
    return 100.0 * bound_ms / (kernel_ns / 1e6 / len(ctx.steps))
