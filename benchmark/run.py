"""Runs one cell of ``BENCHMARK.json`` once on the GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit)
and the same checks as the last lines of standard error.  Exits non-zero
and prints no result when there is no CUDA device, when the cell needs
more devices than there are, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   T_START)


def execute(cell: str, seed: int, seconds: float, trace: bool,
            t_start: float, fault: str | None = None,
            label: dict | None = None) -> int:
    """One run of ``cell`` on the GPU, printed as set out above; ``fault``
    breaks its timed path (``benchmark.control``), and ``label``'s keys
    lead the printed line."""
    import torch

    from . import harness

    chips = harness.find_cell(harness.benchmark(), cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    line, checks = harness.run(cell, seed % 2**64, seconds, trace,
                               fault=fault, t_start=t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps({**(label or {}), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
