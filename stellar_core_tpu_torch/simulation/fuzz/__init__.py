"""Seeded fault-schedule fuzzer over the chaos engine (ISSUE 20).

The subsystem has four parts, one module each:

- ``schedule``  — the serializable schedule IR (JSON), its validator,
  canonical byte form, the pure-function-of-one-seed generator, and
  the hand-built known-bad schedule the minimizer tests shrink.
- ``executor``  — compile a schedule against the chaos engine and run
  it under the full oracle stack (no-fork, convergence, time-to-heal,
  invariants, traffic accounting), returning a classified result with
  a deterministic failure fingerprint and a novelty signature.
- ``minimize``  — event-subset ddmin then parameter shrinking over a
  failing schedule, re-running the oracles at every step, plus the
  repro artifact format ``tools/fuzz_repro`` replays.
- ``campaign``  — the corpus loop: generate, run, retain novel
  schedules, minimize + persist failures, aggregate stats.
"""
from .schedule import (  # noqa: F401
    SCHEMA_VERSION, ScheduleError, canonical_bytes, generate_schedule,
    known_bad_schedule, load_schedule, save_schedule, schedule_id,
    validate_schedule,
)
from .executor import run_schedule  # noqa: F401
from .minimize import minimize_schedule, write_repro  # noqa: F401
from .campaign import FuzzCampaign  # noqa: F401
