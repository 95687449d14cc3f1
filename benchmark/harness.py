"""Runs one cell: finds its pieces by name, sets up, measures a window of
whole steps, reads the metrics, judges the outputs and builds the line.

A driver (``drivers/<name>.py``) provides:

- ``setup(ctx)`` -> state: build the program, make the traffic, warm up
  every path the window will take (counted in ``setup_s``);
- ``prepare(ctx, state, i)``: the benchmark's own work before step ``i``
  (taking its envelopes from what set-up made); not in the step's time,
  but in the window's;
- ``step(ctx, state, i)``: step ``i`` of the program, returning once its
  work is done on the host and the device; timed, with ``ctx.span``
  around each layer it calls;
- ``after(ctx, state, i)``: bookkeeping after step ``i``; not timed;
- ``collect(ctx, state)`` -> outputs: what the program produced, read back
  once the window has closed;
- ``judge(ctx, outputs)`` -> {check: (value, limit)}: the comparison with
  the plain reference, run after the program's state is freed.

The window runs from the start of its first step to the end of its
last, the benchmark's work between steps included; drivers make their
traffic in set-up, so that this work is a few list operations a step,
and a window that outruns that traffic stops the run.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stellar_core_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(name: str):
    """The module of ``metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    key = f"benchmark.metrics.{name}"
    if key not in sys.modules:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def metrics_for(bench: dict, name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): those that list the cell, or list no cells and, per layer,
    move an end-to-end metric that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a run knows: its cell, its deployment, its traffic parameters,
    the steps and spans it timed, and the counters its driver kept."""

    def __init__(self, cell_name, seed, seconds, trace, device, bench,
                 overrides=None):
        self.cell = cell_name
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        entry = find_cell(bench, cell_name)
        self.workload = workload(cell_name)
        self.config = config(entry["config"])
        # tests shrink a deployment to what the CPU can run
        for key, value in (overrides or {}).items():
            target = self.config if key in self.config else self.workload
            if isinstance(value, dict):
                target[key] = {**target.get(key, {}), **value}
            else:
                target[key] = value
        self.steps: list[tuple[int, int]] = []   # perf_counter_ns
        self.spans: list[tuple[str, int, int]] = []
        self.counters: dict = {}
        self.attempted = 0
        self.failed = 0
        self.trace_summary = None
        self.wall_offset_ns = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((label, t0, time.perf_counter_ns()))

    @property
    def window_s(self) -> float:
        """From the first step's start to the last step's end."""
        if not self.steps:
            return 0.0
        return (self.steps[-1][1] - self.steps[0][0]) / 1e9

    def span_seconds(self, label: str) -> float:
        return sum(b - a for lab, a, b in self.spans if lab == label) / 1e9

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault=None, overrides=None,
        t_start: float | None = None) -> tuple[dict, dict]:
    """One run of the cell.  Returns the result line and the checks
    ({name: (value, limit)}).  ``fault`` (``faults.FAULTS``) breaks the
    timed path for the window; ``overrides`` shrink the deployment."""
    import torch

    from . import faults
    from .trace import Trace

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    dev = torch.device(device)
    ctx = Context(cell_name, seed, seconds, trace, dev, bench, overrides)
    drv = driver(ctx.workload["driver"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = drv.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    gc.collect()
    ctx.spans.clear()      # the warm-up's spans are not the window's

    tracer = Trace(dev) if trace else contextlib.nullcontext()
    breaker = faults.FAULTS[fault](ctx) if fault else contextlib.nullcontext()
    drv.window_open(ctx, state)
    i = 0
    with breaker, tracer:
        opened = time.perf_counter_ns()
        while time.perf_counter_ns() - opened < seconds * 1e9:
            drv.prepare(ctx, state, i)
            t0 = time.perf_counter_ns()
            drv.step(ctx, state, i)
            ctx.sync()
            ctx.steps.append((t0, time.perf_counter_ns()))
            drv.after(ctx, state, i)
            i += 1
    drv.window_close(ctx, state)
    print("steps_ms: " + " ".join(f"{(b - a) / 1e6:.1f}" for a, b in ctx.steps),
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if trace:
        t0 = time.perf_counter()
        ctx.trace_summary = s = tracer.reduce(ctx)
        print(f"trace: {s['events']} device events, {s['events_in_steps']} "
              f"within the steps; read in {tracer.read_s:.1f} s, reduced in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    outputs = drv.collect(ctx, state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.judge(ctx, outputs)

    correct = all(v <= limit for v, limit in checks.values())
    line = {"correct": correct, "attempted": ctx.attempted,
            "failed": ctx.failed, "metrics": metrics,
            "device": device_block(dev, peak, ctx)}
    if ctx.trace_summary is not None:
        line["breakdown"] = ctx.trace_summary["breakdown"]
    line["steps"] = len(ctx.steps)
    line["checks"] = {k: {"value": v, "limit": limit}
                      for k, (v, limit) in checks.items()}
    return line, checks


def device_block(dev, peak: int, ctx: Context) -> dict:
    import torch

    if dev.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                 "count": 1, "memory_peak_bytes": peak}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0}
    if ctx.trace_summary is not None:
        block["busy_s"] = ctx.trace_summary["busy_s"]
        block["window_s"] = ctx.trace_summary["window_s"]
    return block
