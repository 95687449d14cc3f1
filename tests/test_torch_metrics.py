"""The port's metrics registry when a garbage collection starts inside its
registration lock, against the JAX package's.

Any allocation may start a collection, and a collection runs the process's
gc callbacks on the thread that allocated.  ``utils/vitals``'s callback
registers metrics (``vitals.gc.pause``, ``vitals.gc.gen<n>.collections``)
the first time it runs.  When that first run fell inside another
registration, the JAX registry's plain ``threading.Lock`` was taken twice
by one thread and the process hung (a tier-1 worker stopped in
``tests/test_consensus_forensics.py::test_vitals_slo_quorum_availability_breach``).
The port's registry lock is re-entrant.

Each case registers a metric whose construction runs a collection, with a
gc callback that registers a new metric, in a thread of a fresh process:
the port registers both; the JAX package's registry deadlocks (kept as the
reference is, pinned here).  Tolerance: exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROG = """
import gc, itertools, os, sys, threading
from {pkg}.utils.metrics import Gauge, MetricsRegistry

reg = MetricsRegistry()
ids = itertools.count()


class Collecting(Gauge):
    def __init__(self):
        super().__init__()
        gc.collect()          # a collection starts under the lock


def on_gc(phase, info):
    # as utils/vitals does: the callback registers a metric
    if phase == "stop" and threading.current_thread() is worker:
        reg.counter("gc.%d" % next(ids)).inc()


worker = threading.Thread(target=lambda: reg._get("g", Collecting),
                          daemon=True)
gc.callbacks.append(on_gc)
worker.start()
worker.join(5)
print("deadlocked" if worker.is_alive() else
      "registered " + " ".join(sorted(reg.snapshot())), flush=True)
os._exit(0)
"""


@pytest.mark.parametrize("pkg,registers", [
    ("stellar_core_tpu_torch", True),
    ("stellar_core_tpu", False),
])
def test_a_collection_inside_a_registration(pkg, registers):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", PROG.format(pkg=pkg)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = res.stdout.split()
    if registers:
        # the metric and the callback's first one (an automatic collection
        # on the thread may add more)
        assert got[0] == "registered" and {"g", "gc.0"} <= set(got[1:])
    else:
        assert got == ["deadlocked"]
