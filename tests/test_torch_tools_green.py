"""The port's ``tools/verify_green`` and ``tools/capture_loop`` on the CPU.

``verify_green``, with its subprocesses injected (a fake runner that writes
each command's log or report): the tier-1 line is ROADMAP.md's with its
test path narrowed to ``tests/test_torch_*.py`` (and its log moved to the
gate's temporary directory); a lint failure is reported as its own
``LINT RED`` line, distinct from test failures, and both turn the gate red
with exit 1; every smoke runs one of the port's tools
(``python -m stellar_core_tpu_torch.tools.<tool>``, ``--device`` passed on)
or the narrowed tier-1 line, never a JAX tool; a red smoke report turns the
gate red.  Then the netobs smoke for real, on the ``cpu`` arm.

``capture_loop``: the workload equals the repository tool's
(``tools/tpu_capture_loop.build_workload``) byte for byte; a run on the CPU
writes its three files only with ``--out``; a probe that finds no device
exits 1.

Both exit 2 with no GPU and no ``--device``, with nothing on stdout.

Tolerance: exact (commands, exit codes, workload bytes).
"""
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.tools import capture_loop
from stellar_core_tpu_torch.tools import verify_green as VG

PKG = "stellar_core_tpu_torch"


@pytest.mark.parametrize("mod", [VG, capture_loop])
def test_without_a_gpu_exits_2(mod, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert mod.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    assert not list(tmp_path.iterdir())


def test_tier1_line_is_roadmaps_narrowed_to_the_port(tmp_path):
    text = Path(VG.ROOT, "ROADMAP.md").read_text()
    line = re.search(r"\*\*Tier-1 verify:\*\* `(.+?)`", text, re.S).group(1)
    got = VG.tier1_command()
    assert got == line.replace("-m pytest tests/ ",
                               "-m pytest tests/test_torch_*.py ")
    assert got != line and VG.T1_LOG in got
    (tmp_path / "ROADMAP.md").write_text("no line here\n")
    with pytest.raises(SystemExit) as exc:
        VG.tier1_command(str(tmp_path))
    assert exc.value.code == 2


GATES_OK = {"hop_records_nonzero": True, "coverage_percentiles_present": True,
            "tracing_overhead_ok": True, "inert_hashes_and_meta": True,
            "attribution_ok": True, "tracing_overhead_pct": 0.1,
            "attributed_pct": 97.0}
REPORTS = {
    "--credit-smoke": {"smoke": [{"backend": "cpu", "shapes": {"credit": {
        "parity_identical": True, "native_hit_rate": 1.0, "aborts": 0}}}]},
    "--fee-smoke": {"smoke": [{"backend": "cpu", "parity_identical": True,
                               "fee_batch_hit_rate": 1.0}]},
    "pipeline_bench": {"parity": [{"backend": "cpu", "hashes_identical": True,
                                   "meta_bytes_identical": True}]},
    "--lockdep-probe": {"rows": [{"backend": "cpu", "acquires_per_close": 10,
                                  "guard_checks_per_close": 10,
                                  "close_p50_ms": 100.0, "inversions": 0,
                                  "guard_violations": 0}]},
    "chaos_bench": {"scenarios": [{"fork_check": "pass",
                                   "rerun_identical": True}]},
    "soak_bench": {"runs": [{"backend": "cpu", "vitals": {"samples": 30},
                             "slo": {"watchdog_green": True},
                             "disabled_cost": {"disabled_pct": 0.1},
                             "parity": {"hashes_identical": True,
                                        "meta_bytes_identical": True}}]},
    "scp_forensics_bench": {"fork_probe": [{
        "backend": "cpu", "attributed_to_byzantine": True,
        "rerun_dump_identical": True}]},
    "catchup_bench": {"minimal": {"bit_identical": True,
                                  "bucket_applied_entries": 5},
                      "complete": {"bit_identical": True,
                                   "ledgers_replayed": 3}},
    "--netobs": {"tiers": {"core4": {"cpu": {"gates": GATES_OK, "on": {}}}}},
    "fuzz_bench": {"problems": [], "runs": [{"backend": "cpu"}]},
}


class FakeRunner:
    """Records every command; writes each pytest log and tool report the
    command names; ``lint_rc`` and ``t1_summary`` set the verdicts."""

    def __init__(self, lint_rc=0, t1_summary="12 passed in 3.0s",
                 reports=REPORTS):
        self.calls, self.lint_rc, self.t1 = [], lint_rc, t1_summary
        self.reports = reports

    def _report(self, cmd):
        for key in ("--credit-smoke", "--fee-smoke", "--lockdep-probe",
                    "--netobs"):
            if key in cmd:
                return self.reports[key]
        return self.reports[cmd[2].rsplit(".", 1)[1]]

    def __call__(self, cmd, **kw):
        self.calls.append((cmd, kw.get("env")))
        out, rc = "", 0
        if cmd[:2] == ["bash", "-c"]:
            for log in re.findall(r"(/\S+\.log)\b", cmd[2]):
                if VG.T1_LOG not in log:
                    with open(log, "w") as f:
                        f.write(f"....\n{self.t1}\n")
        elif cmd[1] == "-c":   # the lockdep micro-bench
            out = json.dumps({"raw_us": 0.1, "wit_us": 0.2,
                              "check_us": 0.1}) + "\n"
        elif cmd[2].endswith(".tools.lint"):
            rc = self.lint_rc
        else:
            with open(cmd[cmd.index("--out") + 1], "w") as f:
                json.dump(self._report(cmd), f)
        return types.SimpleNamespace(returncode=rc, stdout=out, stderr="")


def _gate(monkeypatch, capsys, runner, argv):
    monkeypatch.setattr(VG, "_run", runner)
    rc = VG.main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr().out


def test_every_smoke_runs_the_port_and_a_green_gate_exits_0(monkeypatch,
                                                           capsys):
    runner = FakeRunner()
    rc, out = _gate(monkeypatch, capsys, runner, [])
    assert rc == 0, out
    assert "verify_green: GREEN (passed=12, detlint clean" in out
    tools, lines = [], []
    for cmd, env in runner.calls:
        if cmd[:2] == ["bash", "-c"]:
            lines.append((cmd[2], env))
            continue
        assert cmd[0] == sys.executable
        if cmd[1] == "-c":
            assert f"from {PKG}.utils import lockdep" in cmd[2]
            continue
        assert cmd[1] == "-m" and cmd[2].startswith(f"{PKG}.tools.")
        tools.append(cmd[2].rsplit(".", 1)[1])
        if cmd[2] != f"{PKG}.tools.lint":
            assert cmd[-2:] == ["--device", "cpu"]
    assert tools == ["lint", "parallel_apply_bench", "parallel_apply_bench",
                     "pipeline_bench", "chaos_bench", "soak_bench",
                     "scp_forensics_bench", "catchup_bench", "chaos_bench",
                     "chaos_bench", "pipeline_bench", "fuzz_bench"]
    # the tier-1 line, the parallel, fallback and pipelined re-runs, the
    # lockdep subset: the port's tests only, logs in the gate's directory
    assert len(lines) == 5
    for line, env in lines:
        assert "tests/test_" in line and "/tmp/_t1.log" not in line
        files = re.findall(r"tests/test_\S+", line)
        assert files and all(f.startswith("tests/test_torch_") for f in files)
    assert lines[1][1]["PARALLEL_APPLY_WORKERS"] == "2"
    assert (lines[1][1]["NATIVE_APPLY"], lines[2][1]["NATIVE_APPLY"]) == \
        ("1", "0")
    assert lines[3][1]["PIPELINED_CLOSE"] == "1"
    assert lines[4][1]["LOCKDEP"] == "1"
    assert re.findall(r"tests/test_\S+", lines[4][0]) == VG.LOCKDEP_T1_SUBSET


def test_lint_red_is_distinct_from_test_failures(monkeypatch, capsys):
    skip = [f"--skip-{name}-smoke" for name in VG.SMOKES]
    rc, out = _gate(monkeypatch, capsys, FakeRunner(lint_rc=1), skip)
    assert rc == 1
    assert "verify_green: LINT RED (detlint --strict exited 1)" in out
    assert "unbaselined detlint findings" in out.splitlines()[-1]
    assert "failed tests" not in out
    rc, out = _gate(monkeypatch, capsys,
                    FakeRunner(t1_summary="2 failed, 10 passed"), skip)
    assert rc == 1 and "LINT RED" not in out
    assert "RED (2 failed tests); passed=10" in out.splitlines()[-1]
    rc, out = _gate(monkeypatch, capsys, FakeRunner(lint_rc=1),
                    ["--lint-only"])
    assert rc == 1 and out.splitlines()[-1] == \
        "verify_green: LINT RED (detlint --strict exited 1)"
    rc, out = _gate(monkeypatch, capsys, FakeRunner(), ["--lint-only"])
    assert rc == 0 and "LINT GREEN" in out


@pytest.mark.parametrize("smoke,report,key,bad", [
    ("--netobs-smoke", "--netobs", ("tiers", "core4", "cpu", "gates"),
     {**GATES_OK, "inert_hashes_and_meta": False}),
    ("--fuzz-smoke", "fuzz_bench", ("problems",), ["A/B at 50: 1.5x < 2x"]),
    ("--lockdep-smoke", "--lockdep-probe", ("rows",),
     [{"backend": "cpu", "inversions": 1, "guard_violations": 0}]),
])
def test_a_red_smoke_report_turns_the_gate_red(smoke, report, key, bad,
                                               monkeypatch, capsys):
    rc, out = _gate(monkeypatch, capsys, FakeRunner(), [smoke])
    assert rc == 0 and "GREEN" in out.splitlines()[-1]
    reports = json.loads(json.dumps(REPORTS))
    node = reports[report]
    for k in key[:-1]:
        node = node[k]
    node[key[-1]] = bad
    rc, out = _gate(monkeypatch, capsys, FakeRunner(reports=reports),
                    [smoke])
    assert rc == 1 and "RED (" in out.splitlines()[-1]


def test_netobs_smoke_for_real_on_the_cpu_arm(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.verify_green",
         "--netobs-smoke", "--device", "cpu"],
        cwd=VG.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    last = res.stdout.splitlines()[-1]
    assert last.startswith("verify_green: GREEN (netobs smoke: cpu 980 hop "
                           "records, t90 p90=0.05s")


# -- the capture loop --------------------------------------------------------

def test_workload_equals_the_repository_tools(tmp_path, monkeypatch):
    from tools import tpu_capture_loop as jax_loop

    monkeypatch.setattr(jax_loop, "N", 40)
    monkeypatch.setattr(jax_loop, "NPZ", str(tmp_path / "w.npz"))
    monkeypatch.setattr(jax_loop, "LOG", str(tmp_path / "loop.log"))
    jax_loop.build_workload()
    want = np.load(tmp_path / "w.npz")
    got = capture_loop.build_workload(40)
    for name, arr in zip(("pk", "sg", "mg"), got):
        assert arr.dtype == np.uint8 and np.array_equal(arr, want[name])


def test_capture_on_the_cpu_writes_only_with_out(tmp_path, monkeypatch,
                                                 capsys):
    from stellar_core_tpu_torch import bench_device

    monkeypatch.setattr(bench_device, "REPS", 1)
    monkeypatch.chdir(tmp_path)
    assert capture_loop.main(["--n", "8", "--device", "cpu"]) == 0
    cap = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (cap["kernel"], cap["device"], cap["n_signatures"],
            cap["n_padded"]) == ("plain", "cpu", 8, 256)
    assert cap["vs_cpu"] == round(cap["rate"] / cap["cpu_rate"], 2)
    assert not list(tmp_path.iterdir())
    out = tmp_path / "cap"
    assert capture_loop.main(["--n", "8", "--device", "cpu", "--out",
                              str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "capture.json", "capture_loop.log", "capture_workload.npz"]
    assert json.loads((out / "capture.json").read_text())["n_signatures"] \
        == 8


def test_probe_without_a_device_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(capture_loop, "probe_device",
                        lambda timeout=300.0: {"cuda": False, "count": 0})
    monkeypatch.setattr(capture_loop, "device_stage", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("no stage without a device")))
    assert capture_loop.main(["--n", "4"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device; no capture" in out.err
