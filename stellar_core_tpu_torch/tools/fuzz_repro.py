"""Replay a persisted fuzz repro artifact on the port and check replay
identity: the counterpart of the repository's ``tools/fuzz_repro.py``.

A repro artifact (``traces/FUZZ_REPRO_*.json``, written by the fuzz
campaign's minimizer) carries a minimized schedule plus the failure class
and fingerprint it is expected to reproduce.  This tool re-runs the
schedule under the full oracle stack, every node on the GPU with its
device tiers unless ``--device cpu`` (the host tiers, for tests) is given,
and prints its verdict as one JSON line:

- exit 0: the run failed with the SAME class and the SAME failure
  fingerprint (replay identity holds),
- exit 1: the run passed, or failed differently (the repro rotted),
- exit 2: the artifact itself is invalid (corrupted JSON, oversized,
  unknown schema, schedule fails validation),
- exit 3: no ``--device`` and no GPU.

Usage:
    python -m stellar_core_tpu_torch.tools.fuzz_repro \\
        traces/FUZZ_REPRO_fork_<id>.json [--device cpu]
"""
import argparse
import functools
import json
import sys
import tempfile

from ..simulation.fuzz.executor import run_schedule
from ..simulation.fuzz.minimize import verify_repro
from ..simulation.fuzz.schedule import ScheduleError, load_schedule, \
    schedule_id
from . import add_device_arg, no_gpu, node_kw

PROG = "python -m stellar_core_tpu_torch.tools.fuzz_repro"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=PROG, description="replay a fuzz repro artifact on the port "
                               "and check its failure class + fingerprint")
    ap.add_argument("repro", help="path to a FUZZ_REPRO_*.json artifact")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.device is None and no_gpu(PROG):
        return 3

    try:
        # strict loader: size cap, JSON parse, schedule validation
        doc = load_schedule(args.repro)
        if not isinstance(doc, dict) or "fuzz_repro_schema" not in doc:
            raise ScheduleError(
                f"{args.repro}: not a fuzz repro artifact "
                f"(missing fuzz_repro_schema)")
        sched = doc["schedule"]
    except (OSError, ValueError) as e:  # ScheduleError is a ValueError
        print(f"INVALID: {e}", file=sys.stderr)
        return 2

    sid = schedule_id(sched)
    with tempfile.TemporaryDirectory(prefix="fuzz-repro-") as traces:
        # slow-close traces of the run's nodes stay out of the cwd
        verdict = verify_repro(doc, run=functools.partial(
            run_schedule, TRACE_DIR=traces, **node_kw(args.device)))
    print(json.dumps({"repro": args.repro, "schedule_id": sid,
                      **node_kw(args.device), **verdict}, sort_keys=True),
          flush=True)
    return 0 if verdict["reproduced"] else 1


if __name__ == "__main__":
    sys.exit(main())
