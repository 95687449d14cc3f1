"""On the GPU: one short run of each cell through the benchmark's own
command, and the control (every verdict true) on one seed, at the cells'
own sizes.  ``python3 -m pytest benchmark/tests -m cuda -q``."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def _last_line(args):
    proc = subprocess.run([sys.executable, "-m", *args], cwd=harness.REPO,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    line = _last_line(["benchmark.run", "--workload", cell, "--seed",
                       str(2**31 + 501), "--seconds", "5", "--trace", "1"])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    line = _last_line(["benchmark.control", "--workload", cell, "--fault",
                       "accept_all", "--seed", str(2**31 + 502),
                       "--seconds", "5"])
    assert not line["correct"], line["checks"]
