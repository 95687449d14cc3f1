"""The traced window: ``torch.profiler`` over every step, reduced to the
device's busy time, its operations by name and its idle time by what the
host was doing.

Only the device's activity is recorded (``ProfilerActivity.CUDA``), so the
host pays the tracing of kernels and copies and not of every operator
call.  The profiler's timestamps are on the Unix clock; the benchmark's
steps and spans are on ``perf_counter`` and are moved onto it by the
offset that the run measured at its start.
"""
from __future__ import annotations

import bisect

TOP = 10


class Intervals:
    """Merged, sorted busy intervals, with their overlap with [a, b)."""

    def __init__(self, pairs):
        merged = []
        for a, b in sorted(pairs):
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1][1] = b
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def overlap(self, a: int, b: int) -> int:
        """Length of the busy part of [a, b)."""
        if b <= a or not self.starts:
            return 0
        i = bisect.bisect_right(self.ends, a)      # first interval ending after a
        j = bisect.bisect_left(self.starts, b)     # intervals starting before b
        if i >= j:
            return 0
        total = self.cum[j] - self.cum[i]
        total -= max(0, a - self.starts[i])
        total -= max(0, self.ends[j - 1] - b)
        return total


class Trace:
    """Profiles the device while the window runs (CUDA devices only)."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.events: list[tuple[str, int, int]] = []
        self.read_s = 0.0

    def __enter__(self):
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        import time

        import torch

        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in self.prof.profiler.kineto_results.events()
                       if e.device_type() == cuda]
        self.prof = None
        self.read_s = time.perf_counter() - t0
        return False

    def reduce(self, ctx) -> dict:
        """busy_s and window_s over the window (the first step's start to
        the last step's end), the device operations that took most time,
        and the window's idle time by span label (``harness`` for idle
        time outside every span: the benchmark's work between steps)."""
        off = ctx.wall_offset_ns
        busy = Intervals((a, b) for _, a, b in self.events)
        start, end = ctx.steps[0][0] + off, ctx.steps[-1][1] + off
        window_ns = end - start
        busy_ns = busy.overlap(start, end)
        steps = Intervals((a + off, b + off) for a, b in ctx.steps)
        ops: dict[str, int] = {}
        inside = 0
        for name, a, b in self.events:
            ops[name] = ops.get(name, 0) + (b - a)
            inside += steps.overlap(a, b) > 0
        idle: dict[str, int] = {}
        spans_idle = 0
        for label, a, b in ctx.spans:
            gap = (b - a) - busy.overlap(a + off, b + off)
            idle[label] = idle.get(label, 0) + gap
            spans_idle += gap
        rest = window_ns - busy_ns - spans_idle
        if rest > 0:
            idle["harness"] = rest

        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"busy_s": busy_ns / 1e9, "window_s": window_ns / 1e9,
                "ops_ns": ops, "events": len(self.events),
                "events_in_steps": inside,
                "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def idle_pct(ctx):
    """100 less the device's busy share of the traced steps; None where
    the trace saw no device work."""
    s = ctx.trace_summary
    if s is None or s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
