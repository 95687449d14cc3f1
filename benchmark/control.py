"""Runs one cell once with its timed path broken, for the control and
the fault readings that the limits of ``correct`` are set from.

    python3 -m benchmark.control --workload <cell> --fault <name> \
        --seed <n> --seconds <s>

``--fault`` is one of ``faults.FAULTS``: ``accept_all`` is the control
(every signature verdict true, on the host and on the card), and
``drop_half`` and ``unchanged`` are the faults of a step.  Prints the
result line with the fault's name; the run has to come out not correct.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from . import faults
    from .run import execute

    if args.fault not in faults.FAULTS:
        ap.error(f"--fault: one of {', '.join(faults.FAULTS)}")
    return execute(args.workload, args.seed, args.seconds, False, t_start,
                   fault=args.fault, label={"workload": args.workload,
                                            "fault": args.fault,
                                            "seed": args.seed})


if __name__ == "__main__":
    sys.exit(main())
