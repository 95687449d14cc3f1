"""The must-be-green gate of the port, the counterpart of the repository's
``tools/verify_green.py``: the port's detlint in ``--strict`` mode, then the
tier-1 command as ROADMAP.md states it, restricted to the port's tests
(``tests/test_torch_*.py``), then the smokes, each through the port's own
tool (``python -m stellar_core_tpu_torch.tools.<tool>``) with the flags the
repository's smokes pass.  Exits non-zero on any unbaselined lint finding,
test failure, collection error or failed smoke.

Lint findings are reported DISTINCTLY from test failures (a separate
"verify_green: LINT RED" line), so a red gate says which discipline broke.
The tier-1 line is parsed out of ROADMAP.md (one source of truth) and its
test path narrowed to the port's files; its log goes to the gate's own
temporary directory.  After the default pass the same line runs again with
parallel apply forced on (``PARALLEL_APPLY_WORKERS=2``), with the native
apply switched off (the fallback parity), and with the pipelined close
forced on (``PIPELINED_CLOSE=1``).

Every tool runs on the GPU (its ``cuda`` and ``cpu`` arms) unless
``--device cpu`` is given, which is passed on to every tool (its ``cpu``
arm alone); with no GPU and no ``--device`` the gate exits 2 before any
work.  The smokes' reports go to the gate's temporary directory, removed
at the end: the gate writes no file of its own.

Usage: python -m stellar_core_tpu_torch.tools.verify_green [--device cpu]
           [--timings] [--skip-<name>-smoke ...] [--parallel-smoke-only]
       ... --lint-only      ONLY the port's detlint --strict
       ... --netobs-smoke   ONLY the network-observatory gate
       ... --fuzz-smoke     ONLY the fault-schedule-fuzzer gate
       ... --lockdep-smoke  ONLY the runtime lockdep-witness gate
The smokes, in order: parallel, fallback, credit, fee, pipeline, chaos,
soak, forensics, catchup, netobs, lockdep, fuzz.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

from . import no_gpu

PROG = "python -m stellar_core_tpu_torch.tools.verify_green"
PACKAGE = "stellar_core_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT_TESTS = "tests/test_torch_*.py"
T1_LOG = "/tmp/_t1.log"   # where the ROADMAP line writes its log

#: the port's test files that run the cases of the repository's threaded-
#: subsystem subset (tests/test_lockdep.py, test_pipelined_close.py,
#: test_bucket_list.py, test_metrics.py, test_txtrace.py, test_tracing.py)
#: on the port, which the lockdep smoke re-runs under LOCKDEP=1
LOCKDEP_T1_SUBSET = [
    "tests/test_torch_lockdep.py",
    "tests/test_torch_tools_workloads.py",
    "tests/test_torch_tools_bucket.py",
    "tests/test_torch_metrics.py",
    "tests/test_torch_cli.py",
    "tests/test_torch_tools_trace.py",
]

SMOKES = ("parallel", "fallback", "credit", "fee", "pipeline", "chaos",
          "soak", "forensics", "catchup", "netobs", "lockdep", "fuzz")

# the subprocess runner (tests inject their own)
_run = subprocess.run


def say(msg: str) -> None:
    print(f"verify_green: {msg}", flush=True)


def tier1_command(root: str = ROOT) -> str:
    """ROADMAP.md's tier-1 line with its test path narrowed to the port's
    test files; exits 2 when the line is missing or names no ``tests/``."""
    with open(os.path.join(root, "ROADMAP.md")) as f:
        text = f.read()
    m = re.search(r"\*\*Tier-1 verify:\*\* `(.+?)`", text, re.S)
    if not m or len(re.findall(r"-m pytest tests/ ", m.group(1))) != 1:
        print("verify_green: no tier-1 command over tests/ found in "
              "ROADMAP.md", file=sys.stderr)
        sys.exit(2)
    return m.group(1).replace("-m pytest tests/ ",
                              f"-m pytest {PORT_TESTS} ")


def tool_cmd(tool: str, *flags: str, device=None) -> list:
    """The command line of one of the port's tools, ``--device`` passed on."""
    return [sys.executable, "-m", f"{PACKAGE}.tools.{tool}", *flags,
            *(["--device", device] if device else [])]


def run_detlint() -> int:
    """The port's detlint --strict; non-zero = unbaselined findings."""
    cmd = [sys.executable, "-m", f"{PACKAGE}.tools.lint", "--strict"]
    say(" ".join(cmd[1:]))
    return _run(cmd, cwd=ROOT).returncode


def _tail(proc, n: int = 6) -> str:
    return "\n".join(((proc.stdout or "") + (proc.stderr or ""))
                     .splitlines()[-n:])


def _counts(log: str, tag: str) -> tuple:
    """(problems, passed) from the summary lines of a pytest log."""
    tail = "\n".join(log.splitlines()[-30:])
    problems = []
    for pat, what in ((r"\b([1-9]\d*) failed\b", "failed tests"),
                      (r"\b([1-9]\d*) errors?\b", "collection errors")):
        m = re.search(pat, tail)
        if m:
            problems.append(f"{tag}{m.group(1)} {what}")
    m = re.search(r"\b(\d+) passed\b", tail)
    return problems, (m.group(1) if m else "?")


def _read(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def _jsonl(path: str) -> list:
    rows = []
    for line in _read(path).splitlines():
        try:
            rows.append(json.loads(line))
        except ValueError:
            continue
    return rows


def run_tier1_line(cmd: str, tag: str, env_extra: dict, tmp: str) -> tuple:
    """The restricted tier-1 line again with ``env_extra`` exported, its log
    in ``tmp``.  Returns (problems, passed)."""
    log_path = os.path.join(tmp, f"_t1_{tag}.log")
    line = cmd.replace(T1_LOG, log_path)
    env = dict(os.environ, **env_extra)
    say(f"[{tag} smoke] "
        + " ".join(f"{k}={v}" for k, v in env_extra.items()
                   if not k.endswith("_FILE")) + f" {line}")
    proc = _run(["bash", "-c", line], cwd=ROOT, env=env)
    problems = [] if proc.returncode == 0 else \
        [f"{tag} smoke exited {proc.returncode}"]
    log = _read(log_path)
    if not log:
        problems.append(f"{tag} smoke log missing")
    more, passed = _counts(log, f"{tag} smoke: ")
    return problems + more, passed


def run_parallel_smoke(cmd: str, tmp: str, native: bool = True) -> tuple:
    """The tier-1 line with parallel apply forced on; ``native=False`` also
    exports the NATIVE_APPLY=0 kill switch (the fallback parity).  Returns
    (problems, passed, abort summary)."""
    tag = "parallel" if native else "fallback"
    stats = os.path.join(tmp, f"_t1p_{tag}_apply_stats.jsonl")
    problems, passed = run_tier1_line(cmd, tag, {
        "PARALLEL_APPLY_WORKERS": "2", "PARALLEL_APPLY_STATS_FILE": stats,
        "NATIVE_APPLY": "1" if native else "0"}, tmp)
    keys = ("parallel_closes", "sequential_closes", "aborts", "unplanned",
            "native_hits", "native_declines")
    rows = _jsonl(stats)
    tot = {k: sum(int(r.get(k, 0)) for r in rows) for k in keys}
    summary = (f"{tot['parallel_closes']} parallel closes, "
               f"{tot['aborts']} aborts, {tot['unplanned']} unplanned, "
               f"{tot['native_hits']} native hits, "
               f"{tot['native_declines']} declines, {len(rows)} app sessions")
    reasons = [x for r in rows for x in r.get("escape_reasons", [])]
    if reasons:
        summary += f"; escapes: {reasons[:4]}"
    return problems, passed, summary


def run_tool_report(tag: str, tool: str, flags: list, device, tmp: str,
                    env_extra=None, timeout: float = 900) -> tuple:
    """Run one tool with ``--out`` in ``tmp``: (its report or None, the
    process, problems when it could not be read)."""
    out = os.path.join(tmp, f"_t1_{tag}_smoke.json")
    cmd = tool_cmd(tool, *flags, "--out", out, device=device)
    say(f"[{tag} smoke] {' '.join(cmd[1:])}")
    env = dict(os.environ, **(env_extra or {}))
    proc = _run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=timeout)
    try:
        with open(out) as f:
            return json.load(f), proc, []
    except (OSError, ValueError) as e:
        return None, proc, [f"{tag} smoke report unreadable: {e} "
                            f"(exit {proc.returncode}): {_tail(proc)}"]


def _exit_problem(tag: str, proc, problems: list) -> list:
    if proc.returncode != 0 and not problems:
        return [f"{tag} smoke exited {proc.returncode}: {_tail(proc)}"]
    return []


def run_credit_native_smoke(device, tmp) -> tuple:
    """Credit-mix and path-payment closes bit-identical native-vs-Python,
    native cluster-hit rate >= 0.9, no aborts, on every backend arm."""
    rep, proc, problems = run_tool_report(
        "credit", "parallel_apply_bench", ["--credit-smoke"], device, tmp)
    if rep is None:
        return problems, "failed"
    parts = []
    for arm in rep.get("smoke", []):
        b = arm.get("backend")
        for shape, row in sorted(arm.get("shapes", {}).items()):
            if not row.get("parity_identical"):
                problems.append(f"credit-native smoke: {b}/{shape} "
                                "native/Python parity DIVERGED")
            if row.get("aborts"):
                problems.append(f"credit-native smoke: {b}/{shape} "
                                f"{row['aborts']} aborts")
            if row.get("native_hit_rate", 0.0) < 0.9:
                problems.append(
                    f"credit-native smoke: {b}/{shape} hit rate "
                    f"{row.get('native_hit_rate')} < 0.9 "
                    f"(declines: {row.get('decline_reasons')})")
            parity = "ok" if row.get("parity_identical") else "FAILED"
            parts.append(f"{b}/{shape} hit_rate="
                         f"{row.get('native_hit_rate')} parity={parity}")
    problems += _exit_problem("credit-native", proc, problems)
    return problems, ", ".join(parts) or "no shapes reported"


def run_fee_native_smoke(device, tmp) -> tuple:
    """NATIVE_FEE on/off closes bit-identical and the charge_fees batch
    carrying >= 90% of closes, on every backend arm."""
    rep, proc, problems = run_tool_report(
        "fee", "parallel_apply_bench", ["--fee-smoke"], device, tmp)
    if rep is None:
        return problems, "failed"
    parts = []
    for arm in rep.get("smoke", []):
        b = arm.get("backend")
        if not arm.get("parity_identical"):
            problems.append(f"fee-native smoke: {b} NATIVE_FEE on/off "
                            "parity DIVERGED")
        if arm.get("fee_batch_hit_rate", 0.0) < 0.9:
            problems.append(f"fee-native smoke: {b} fee-batch hit rate "
                            f"{arm.get('fee_batch_hit_rate')} < 0.9 "
                            f"(counters: {arm.get('fee_batch')})")
        parity = "ok" if arm.get("parity_identical") else "FAILED"
        parts.append(f"{b} hit_rate={arm.get('fee_batch_hit_rate')} "
                     f"parity={parity}")
    problems += _exit_problem("fee-native", proc, problems)
    return problems, ", ".join(parts) or "no arms reported"


def run_pipelined_smoke(cmd: str, device, tmp) -> tuple:
    """The tier-1 line with PIPELINED_CLOSE=1, then a miniature
    ``pipeline_bench`` (2 closes an arm of 120 txs) whose parity pass
    compares header/bucket hashes and meta bytes pipeline-on vs off.
    Returns (problems, passed, summary)."""
    stats = os.path.join(tmp, "_t1p_pipeline_stats.jsonl")
    problems, passed = run_tier1_line(cmd, "pipeline", {
        "PIPELINED_CLOSE": "1", "PIPELINED_CLOSE_STATS_FILE": stats}, tmp)
    rows = _jsonl(stats)
    tot = {k: sum(int(r.get(k, 0)) for r in rows)
           for k in ("tails", "tail_failures", "prefetch_adopted")}
    if tot["tail_failures"]:
        problems.append(f"pipeline smoke: {tot['tail_failures']} tail "
                        "failures")
    rep, proc, more = run_tool_report(
        "pipeline", "pipeline_bench", ["--closes", "2", "--close-txs",
                                       "120"], device, tmp)
    problems += more
    parity = "unreadable"
    if rep is not None:
        arms = rep.get("parity", [])
        ok = bool(arms) and all(p.get("hashes_identical") and
                                p.get("meta_bytes_identical") for p in arms)
        parity = "identical" if ok else "DIVERGED"
        if not ok:
            problems.append("pipeline on/off hash parity DIVERGED")
        problems += _exit_problem("pipeline parity", proc, problems)
    summary = (f"{tot['tails']} tails over {len(rows)} app sessions, "
               f"{tot['tail_failures']} tail failures, "
               f"{tot['prefetch_adopted']} prefetched keys adopted, "
               f"on/off parity {parity}")
    return problems, passed, summary


def run_chaos_smoke(device, tmp, env_extra=None) -> tuple:
    """One core-4 partition+heal scenario with its same-seed rerun."""
    rep, proc, problems = run_tool_report(
        "chaos", "chaos_bench", ["--tier", "core4", "--scenario",
                                 "partition_heal"], device, tmp,
        env_extra=env_extra, timeout=600)
    if rep is None:
        return problems, "failed"
    try:
        sc = rep["scenarios"][0]
    except (KeyError, IndexError) as e:
        return [f"chaos smoke report unreadable: {e}"], "failed"
    if sc.get("fork_check") != "pass":
        problems.append("chaos smoke: fork check failed")
    if sc.get("rerun_identical") is not True:
        problems.append("chaos smoke: same-seed rerun not bit-identical")
    problems += _exit_problem("chaos", proc, problems)
    return problems, (f"{sc.get('ledgers_closed')} ledgers, "
                      f"heal={sc.get('time_to_heal_s')}s, "
                      f"fork={sc.get('fork_check')}, "
                      f"rerun_identical={sc.get('rerun_identical')}")


def run_soak_smoke(device, tmp) -> tuple:
    """A ~30 s sustained-load soak a backend: the vitals ring populated, no
    SLO breach, the telemetry's disabled cost < 1% of the close p50 and
    its on/off hash+meta parity."""
    rep, proc, problems = run_tool_report("soak", "soak_bench", ["--smoke"],
                                          device, tmp, timeout=600)
    if rep is None:
        return problems, "failed"
    parts = []
    for run in rep.get("runs", []):
        b = run.get("backend")
        vit = run.get("vitals", {})
        if vit.get("samples", 0) < 10:
            problems.append(f"soak smoke: {b} vitals ring underpopulated "
                            f"({vit.get('samples')} samples)")
        if not run.get("slo", {}).get("watchdog_green"):
            problems.append(f"soak smoke: {b} SLO breaches "
                            f"{run.get('slo', {})}")
        pct = run.get("disabled_cost", {}).get("disabled_pct")
        if pct is None or pct >= 1.0:
            problems.append(f"soak smoke: {b} telemetry disabled-cost "
                            f"{pct}% of close p50 (gate: <1%)")
        par = run.get("parity", {})
        if not (par.get("hashes_identical") and
                par.get("meta_bytes_identical")):
            problems.append(f"soak smoke: {b} telemetry on/off parity "
                            "DIVERGED")
        parts.append(f"{b} {run.get('sustained', {}).get('applied_tx_s')} "
                     f"tx/s, {vit.get('samples')} vitals samples, "
                     f"disabled-cost {pct}%")
    problems += _exit_problem("soak", proc, problems)
    return problems, ", ".join(parts) or "no runs reported"


def run_forensics_smoke(device, tmp) -> tuple:
    """The induced fork attributed to the Byzantine node, and its dump
    byte-identical on a same-seed rerun, on every backend arm."""
    rep, proc, problems = run_tool_report(
        "forensics", "scp_forensics_bench", ["--smoke"], device, tmp,
        timeout=600)
    if rep is None:
        return problems, "failed"
    parts = []
    for probe in rep.get("fork_probe", []):
        b = probe.get("backend")
        if not probe.get("attributed_to_byzantine"):
            problems.append(
                f"forensics smoke: {b} fork NOT attributed to the "
                f"Byzantine node (first_divergence="
                f"{probe.get('first_divergence')})")
        if probe.get("rerun_dump_identical") is not True:
            problems.append(f"forensics smoke: {b} same-seed dump not "
                            "byte-identical")
        parts.append(f"{b} fork at slot {probe.get('divergence_slot')} "
                     f"attributed={probe.get('attributed_to_byzantine')}")
    if not parts:
        problems.append("forensics smoke: no fork probe reported")
    return problems, ", ".join(parts) or "failed"


def run_catchup_smoke(device, tmp) -> tuple:
    """A minimal and a complete cold joiner, each ending bit-identical to
    the validators."""
    rep, proc, problems = run_tool_report("catchup", "catchup_bench",
                                          ["--smoke"], device, tmp)
    if rep is None:
        return problems, "failed"
    mn, cp = rep.get("minimal", {}), rep.get("complete", {})
    for tag, row in (("minimal", mn), ("complete", cp)):
        if row.get("bit_identical") is not True:
            problems.append(f"catchup smoke: {tag} joiner NOT "
                            "bit-identical to the validators")
    if mn.get("bucket_applied_entries", 0) <= 0:
        problems.append("catchup smoke: minimal joiner applied no bucket "
                        "entries")
    if cp.get("ledgers_replayed", 0) <= 0:
        problems.append("catchup smoke: complete joiner replayed no "
                        "ledgers")
    problems += _exit_problem("catchup", proc, problems)
    return problems, (f"minimal {mn.get('time_to_synced_s')}s, complete "
                      f"{cp.get('time_to_synced_s')}s "
                      f"({cp.get('ledgers_replayed')} ledgers replayed)")


def run_netobs_smoke(device, tmp) -> tuple:
    """The core-4 network-observatory bench on every backend arm: hop
    records, coverage percentiles, crank attribution >= 90%, the tracing's
    disabled cost < 2% of the close p50, on/off hash+meta inertness, the
    backends' digests equal (the tool asserts that last one)."""
    rep, proc, problems = run_tool_report(
        "netobs", "chaos_bench", ["--netobs", "--tier", "core4"], device,
        tmp, timeout=600)
    if rep is None:
        return problems, "failed"
    arms = rep.get("tiers", {}).get("core4", {})
    if not arms:
        problems.append("netobs smoke: no core4 arm reported")
    parts = []
    for b, res in sorted(arms.items()):
        g = res.get("gates", {})
        for key, what in (
                ("hop_records_nonzero", "no flood hop records"),
                ("coverage_percentiles_present",
                 "coverage percentiles missing"),
                ("tracing_overhead_ok",
                 f"tracing disabled-cost {g.get('tracing_overhead_pct')}% "
                 "of close p50 (gate: <2%)"),
                ("inert_hashes_and_meta",
                 "tracing on/off hash/meta parity DIVERGED"),
                ("attribution_ok",
                 f"only {g.get('attributed_pct')}% of crank wall "
                 "attributed (gate: >=90%)")):
            if not g.get(key):
                problems.append(f"netobs smoke: {b} {what}")
        t90 = (res.get("on", {}).get("observatory", {}).get(
            "propagation", {}).get("time_to_90pct") or {}).get("p90")
        parts.append(f"{b} {res.get('on', {}).get('hop_records_total')} hop "
                     f"records, t90 p90={t90}s, disabled-cost "
                     f"{g.get('tracing_overhead_pct')}%, attributed "
                     f"{g.get('attributed_pct')}%")
    problems += _exit_problem("netobs", proc, problems)
    return problems, ", ".join(parts) or "failed"


LOCKDEP_MICRO = (
    "import json, threading, time\n"
    "from stellar_core_tpu_torch.utils import lockdep\n"
    "raw = threading.Lock()\n"
    "wit = lockdep.register_lock(threading.Lock(), 'bench')\n"
    "assert isinstance(wit, lockdep.WitnessLock)\n"
    "def per_acquire(lk, n=200000):\n"
    "    for _ in range(n // 10):\n"
    "        with lk:\n"
    "            pass\n"
    "    t0 = time.perf_counter()\n"
    "    for _ in range(n):\n"
    "        with lk:\n"
    "            pass\n"
    "    return (time.perf_counter() - t0) / n\n"
    "class B:\n"
    "    pass\n"
    "b = B()\n"
    "b.__dict__['_lock'] = wit\n"
    "b.__dict__['_lockdep_enforced'] = True\n"
    "desc = lockdep._GuardedField('val', '_lock')\n"
    "def per_check(n=200000):\n"
    "    with wit:\n"
    "        t0 = time.perf_counter()\n"
    "        for i in range(n):\n"
    "            desc.__set__(b, i)\n"
    "        return (time.perf_counter() - t0) / n\n"
    "print(json.dumps({'raw_us': per_acquire(raw) * 1e6,\n"
    "                  'wit_us': per_acquire(wit) * 1e6,\n"
    "                  'check_us': per_check() * 1e6}))\n")


def run_lockdep_smoke(device, tmp) -> tuple:
    """Everything under LOCKDEP=1: the port's threaded-subsystem test
    subset, one core-4 chaos scenario and the pipelined-close lockdep
    probe, with zero LockOrderInversion / GuardViolation; then the
    enabled witness's cost, micro-benchmarked and scaled by the probe's
    per-close counts, < 1% of the probe's close p50 on every arm."""
    env = {"LOCKDEP": "1"}
    log_path = os.path.join(tmp, "_t1_lockdep.log")
    sub = (f"timeout -k 10 600 {sys.executable} -m pytest "
           f"{' '.join(LOCKDEP_T1_SUBSET)} -q -m 'not slow' "
           f"-p no:cacheprovider -p no:xdist -p no:randomly "
           f"> {log_path} 2>&1")
    say(f"[lockdep smoke] LOCKDEP=1 {sub}")
    proc = _run(["bash", "-c", sub], cwd=ROOT, env=dict(os.environ, **env))
    log = _read(log_path)
    problems = [] if proc.returncode == 0 else \
        [f"lockdep smoke: subset exited {proc.returncode}"]
    more, passed = _counts(log, "lockdep smoke: ")
    problems += [p for p in more if "failed" in p]

    chaos_problems, _ = run_chaos_smoke(device, tmp, env_extra=env)
    problems += [f"lockdep smoke: {p}" for p in chaos_problems]
    chaos_note = "failed" if chaos_problems else "ok"

    rep, bench, more = run_tool_report(
        "lockdep_pipeline", "pipeline_bench",
        ["--lockdep-probe", "--closes", "6", "--close-txs", "120"], device,
        tmp, env_extra=env, timeout=600)
    problems += [f"lockdep smoke: {p}" for p in more]
    log += (bench.stdout or "") + (bench.stderr or "")
    probes = (rep or {}).get("rows", [])
    for probe in probes:
        if probe.get("inversions") or probe.get("guard_violations"):
            problems.append(
                f"lockdep smoke: {probe.get('backend')} probe saw "
                f"{probe.get('inversions')} inversions / "
                f"{probe.get('guard_violations')} guard violations")
    for marker in ("LockOrderInversion", "GuardViolation"):
        n = log.count(marker)
        if n:
            problems.append(f"lockdep smoke: {n} {marker} in output")

    micro = _run([sys.executable, "-c", LOCKDEP_MICRO], cwd=ROOT,
                 env=dict(os.environ, **env), capture_output=True,
                 text=True, timeout=300)
    notes = []
    if micro.returncode != 0:
        problems.append("lockdep smoke: overhead micro-bench failed: "
                        + _tail(micro, 3))
    else:
        try:
            row = json.loads(micro.stdout.strip().splitlines()[-1])
            acq_us = max(0.0, row["wit_us"] - row["raw_us"])
            chk_us = row["check_us"]
            for probe in probes:
                per_close_ms = (
                    acq_us * probe.get("acquires_per_close", 0.0)
                    + chk_us * probe.get("guard_checks_per_close", 0.0)
                ) / 1000.0
                p50 = probe.get("close_p50_ms") or 20.0
                pct = per_close_ms / p50 * 100.0
                note = (f"{probe.get('backend')} {per_close_ms:.3f}ms/close "
                        f"= {pct:.2f}% of close p50 {p50}ms")
                notes.append(note)
                if pct >= 1.0:
                    problems.append(f"lockdep smoke: witness overhead "
                                    f"{note} (gate: <1%)")
        except (ValueError, KeyError, IndexError) as e:
            problems.append(f"lockdep smoke: overhead report unreadable: {e}")
    return problems, (f"subset passed={passed}, chaos {chaos_note}, "
                      f"witness overhead {'; '.join(notes) or 'unmeasured'}")


def run_fuzz_smoke(device, tmp) -> tuple:
    """Budget-capped seeded schedules under the full oracle stack and the
    known-bad minimize/replay proof, on every backend arm."""
    rep, proc, problems = run_tool_report("fuzz", "fuzz_bench", ["--smoke"],
                                          device, tmp)
    if rep is None:
        return problems, "failed"
    problems = [f"fuzz smoke: {p}" for p in rep.get("problems", [])]
    problems += _exit_problem("fuzz", proc, problems)
    parts = []
    for run in rep.get("runs", []):
        camp = run.get("campaigns", {}).get("smoke", {})
        kb = run.get("known_bad", {})
        parts.append(f"{run.get('backend')} {camp.get('schedules_executed')}"
                     f" schedules ({camp.get('failure_count')} failures), "
                     f"known-bad replay={kb.get('replay_reproduced')}")
    return problems, ", ".join(parts) or "no runs reported"


def print_timings(log: str, top_n: int = 10) -> None:
    """Aggregate pytest's --durations lines per test FILE and print the
    slowest."""
    totals = {}
    for m in re.finditer(
            r"^\s*([0-9.]+)s\s+(?:call|setup|teardown)\s+([^:\s]+)::",
            log, re.M):
        totals[m.group(2)] = totals.get(m.group(2), 0.0) + \
            float(m.group(1))
    if not totals:
        say("no duration lines found in the tier-1 log")
        return
    say(f"{top_n} slowest test files:")
    width = max(len(f) for f in totals)
    for f, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"  {f:<{width}}  {s:8.2f}s", flush=True)


def _verdict(name: str, problems: list, summary: str) -> int:
    say(f"{name}: {summary}")
    if problems:
        say(f"RED ({'; '.join(problems)})")
        return 1
    say(f"GREEN ({name}: {summary})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="pass --device cpu to every tool (their cpu arm, "
                         "the host tiers); default: the GPU")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--netobs-smoke", action="store_true")
    ap.add_argument("--fuzz-smoke", action="store_true")
    ap.add_argument("--lockdep-smoke", action="store_true")
    ap.add_argument("--parallel-smoke-only", action="store_true")
    ap.add_argument("--timings", action="store_true")
    for name in SMOKES:
        ap.add_argument(f"--skip-{name}-smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.device is None and no_gpu(PROG):
        return 2
    device = args.device

    if args.lint_only:
        lint_rc = run_detlint()
        if lint_rc != 0:
            say(f"LINT RED (detlint --strict exited {lint_rc})")
            return 1
        say("LINT GREEN (detlint --strict clean)")
        return 0
    with tempfile.TemporaryDirectory(prefix="verify-green-") as tmp:
        if args.netobs_smoke:
            return _verdict("netobs smoke", *run_netobs_smoke(device, tmp))
        if args.lockdep_smoke:
            return _verdict("lockdep smoke", *run_lockdep_smoke(device, tmp))
        if args.fuzz_smoke:
            return _verdict("fuzz smoke", *run_fuzz_smoke(device, tmp))
        if args.parallel_smoke_only:
            problems, passed, summary = run_parallel_smoke(tier1_command(),
                                                           tmp)
            say(f"parallel-apply smoke: {summary}")
            if problems:
                say(f"RED ({'; '.join(problems)}); passed={passed}")
                return 1
            say(f"GREEN (parallel smoke passed={passed})")
            return 0
        return full_gate(args, device, tmp)


def full_gate(args, device, tmp) -> int:
    """Lint, the restricted tier-1 line, then every smoke not skipped."""
    skip = {name: getattr(args, f"skip_{name}_smoke") for name in SMOKES}
    lint_rc = run_detlint()
    if lint_rc != 0:
        # distinct from test failures: the analyzer printed the findings;
        # the tests still run so one gate run reports both
        say(f"LINT RED (detlint --strict exited {lint_rc})")
    cmd = tier1_command()
    if args.timings:
        cmd = cmd.replace("-m pytest", "-m pytest --durations=0 -vv", 1)
    log_path = os.path.join(tmp, "_t1.log")
    line = cmd.replace(T1_LOG, log_path)
    say(line)
    rc = _run(["bash", "-c", line], cwd=ROOT).returncode
    problems = [] if rc == 0 else [f"tier-1 command exited {rc}"]
    log = _read(log_path)
    if not log:
        problems.append("tier-1 log missing")
    more, passed = _counts(log, "")
    problems += more
    if re.search(r"^=+ ERRORS =+$", log, re.M):
        problems.append("ERRORS section in pytest output")
    if args.timings:
        print_timings(log)
    if lint_rc != 0:
        problems.append("unbaselined detlint findings (see LINT RED above)")

    notes = []

    def smoke(name, label, result):
        p, summary = result[0], result[-1]
        say(f"{label}: {summary}")
        problems.extend(p)
        notes.append(f"{name} smoke: {summary}" if len(result) == 2 else
                     f"{name} smoke passed={result[1]}")

    if not skip["parallel"]:
        smoke("parallel", "parallel-apply smoke", run_parallel_smoke(cmd, tmp))
        if not skip["fallback"]:
            smoke("fallback", "fallback-parity smoke",
                  run_parallel_smoke(cmd, tmp, native=False))
    steps = (("credit", "credit-native smoke",
              lambda: run_credit_native_smoke(device, tmp)),
             ("fee", "fee-native smoke",
              lambda: run_fee_native_smoke(device, tmp)),
             ("pipeline", "pipelined-close smoke",
              lambda: run_pipelined_smoke(cmd, device, tmp)),
             ("chaos", "chaos smoke", lambda: run_chaos_smoke(device, tmp)),
             ("soak", "soak smoke", lambda: run_soak_smoke(device, tmp)),
             ("forensics", "forensics smoke",
              lambda: run_forensics_smoke(device, tmp)),
             ("catchup", "catchup smoke",
              lambda: run_catchup_smoke(device, tmp)),
             ("netobs", "netobs smoke",
              lambda: run_netobs_smoke(device, tmp)),
             ("lockdep", "lockdep smoke",
              lambda: run_lockdep_smoke(device, tmp)),
             ("fuzz", "fuzz smoke", lambda: run_fuzz_smoke(device, tmp)))
    for name, label, step in steps:
        if not skip[name]:
            smoke(name, label, step())
    if problems:
        say(f"RED ({'; '.join(problems)}); passed={passed}")
        return 1
    say(f"GREEN (passed={passed}, detlint clean, {', '.join(notes)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
