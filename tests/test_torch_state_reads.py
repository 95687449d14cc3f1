"""The ledger state's bucket-tier reads and the bucket list's background
merges in a standalone node's record of each ledger
(``LedgerManager.last_close_phases``), and the benchmark cell that reads
them, ``standalone_100k.flooded_1k``, shrunk to what the CPU can run.

Each run is a child process (``CHILD``) that drives the cell's driver
step by step, as ``benchmark/harness.py`` does, with the node's device
paths on their plain torch versions (``device="cpu"``):

- ``outgrown``: the cell at 2,000 accounts funded through closes, 200
  payments a ledger, 2 forged, the entry cache cut to 256 entries, the
  window from ledger 8 (funding closes 3 and 4): most account loads miss
  the cache and come from the bucket list;
- ``cached``: ``standalone.flooded_1k``'s shape (12 accounts), whose
  cache holds every account: no read reaches the bucket tier.

Beside them, the seams one by one: ``LedgerTxnRoot.state_read_stats``
and ``note_bucket_walk``, ``BucketList.take_merge_stats``.

Tolerance: exact counts; ms sums to the record's rounding (0.001 ms a
ledger and key).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SEED = 2**33 + 17
STEPS = 3
OUTGROWN = {"accounts": 2000, "per_ledger": 200, "forged_per_ledger": 2,
            "window_start_seq": 8, "warmup_ledgers": 1,
            "pool_ledgers": STEPS, "sample_per_kind": 2}
CACHED = {"accounts": 12, "per_ledger": 12, "forged_per_ledger": 2,
          "window_start_seq": 7, "warmup_ledgers": 1,
          "pool_ledgers": STEPS, "sample_per_kind": 2}
RUNS = {"outgrown": ("standalone_100k.flooded_1k", OUTGROWN, 256),
        "cached": ("standalone.flooded_1k", CACHED, None)}
KEYS = ("cache_misses", "state_reads", "state_read_ms")
METRICS = ("state.reads_per_ledger", "state.read_ms_per_ledger",
           "bucket.merge_ms_per_ledger")

CHILD = """
import json, sys, time
import torch
from stellar_core_tpu_torch.ledger.ledger_txn import LedgerTxnRoot
from benchmark import harness
args = json.loads(sys.argv[1])
if args["cache"]:
    LedgerTxnRoot.ENTRY_CACHE_SIZE = args["cache"]
ctx = harness.Context(args["cell"], args["seed"], 0, False,
                      torch.device("cpu"), harness.benchmark(),
                      args["overrides"])
drv = harness.driver(ctx.workload["driver"])
st = drv.setup(ctx)
root = st.app.ledger_manager.root
pipe = st.app.ledger_manager.pipeline
deltas, walked = [], []
drv.window_open(ctx, st)
for i in range(args["steps"]):
    drv.prepare(ctx, st, i)
    before = root.state_read_stats()
    keys0 = pipe.stats["prefetch_keys"]
    t0 = time.perf_counter_ns()
    drv.step(ctx, st, i)
    ctx.steps.append((t0, time.perf_counter_ns()))
    deltas.append([a - b for a, b in zip(root.state_read_stats(), before)])
    walked.append(pipe.stats["prefetch_keys"] - keys0)
    drv.after(ctx, st, i)
drv.window_close(ctx, st)
metrics = {m: harness.reader(m).read(ctx) for m in args["metrics"]}
funding = [(len(envs), statuses, closed)
           for envs, statuses, closed, w in st.records
           if not w and envs and envs[0].src < 0]
checks = drv.judge(ctx, drv.collect(ctx, st))
print(json.dumps({"phases": ctx.counters["close_phases"], "deltas": deltas,
                  "walked": walked,
                  "metrics": metrics, "funding": funding,
                  "checks": {k: v for k, (v, _) in checks.items()}}))
"""


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    cell, overrides, cache = RUNS[request.param]
    args = {"cell": cell, "seed": SEED,
            "overrides": overrides,
            "cache": cache, "steps": STEPS, "metrics": METRICS}
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(args)],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["name"] = request.param
    return out


def test_every_check_reads_zero(run):
    assert run["checks"] and all(v == 0 for v in run["checks"].values()), \
        run["checks"]


def test_the_records_sums_are_the_roots_counters(run):
    """Admission's and the close's keys of each window ledger add up to
    what ``LedgerTxnRoot.state_read_stats`` moved over its step."""
    assert len(run["phases"]) == len(run["deltas"]) == STEPS
    for rec, delta in zip(run["phases"], run["deltas"]):
        for k, want in zip(KEYS, delta):
            got = rec["admit_" + k] + rec["close_" + k]
            if k == "state_read_ms":
                assert got == pytest.approx(want * 1000.0, abs=0.002)
            else:
                assert got == want, (k, rec)


def test_the_readers_are_the_records_means(run):
    rows = run["phases"]
    reads = sum(r["admit_state_reads"] + r["close_state_reads"]
                for r in rows) / len(rows)
    ms = sum(r["admit_state_read_ms"] + r["close_state_read_ms"]
             for r in rows) / len(rows)
    merge = sum(r["merge_ms"] for r in rows) / len(rows)
    got = run["metrics"]
    assert got["state.reads_per_ledger"] == pytest.approx(reads)
    assert got["state.read_ms_per_ledger"] == pytest.approx(ms)
    assert got["bucket.merge_ms_per_ledger"] == pytest.approx(merge)
    assert all(r["merge_ms"] >= 0 for r in rows)


def test_reads_reach_the_bucket_tier_only_past_the_cache(run):
    """Past the cache every window ledger reads from the buckets, in its
    admission and in its close; with every account cached only the close
    pipeline's prefetch worker does, which walks the buckets for every
    key of the candidates, cached or not."""
    for rec, walked in zip(run["phases"], run["walked"]):
        assert walked > 0, rec
        if run["name"] == "outgrown":
            assert rec["admit_state_reads"] > 0, rec
            assert rec["admit_state_read_ms"] > 0, rec
            assert rec["admit_cache_misses"] >= rec["admit_state_reads"]
            assert rec["close_state_reads"] >= walked, rec
        else:
            assert rec["admit_state_reads"] == 0, rec
            assert rec["admit_cache_misses"] == 0, rec
            assert rec["close_cache_misses"] == 0, rec
            assert rec["close_state_reads"] == walked, rec


def test_funding_admits_every_create_account(run):
    """The large driver funds its accounts through closes at the cap:
    10 transactions of 100 CreateAccount operations a ledger, every one
    PENDING (the queue answers no TRY_AGAIN_LATER)."""
    if run["name"] == "cached":
        assert [f[0] for f in run["funding"]] == [1]   # one ledger
        return
    funding = run["funding"]
    assert [n for n, _, _ in funding] == [10, 10]
    assert [closed for _, _, closed in funding] == [[3], [4]]
    assert all(s == 0 for _, statuses, _ in funding for s in statuses)


# -- the seams ---------------------------------------------------------------

def _node(cache: int, monkeypatch):
    from chip_smoke import Account
    from stellar_core_tpu_torch.crypto import SecretKey, sha256
    from stellar_core_tpu_torch.ledger.ledger_txn import LedgerTxnRoot
    from stellar_core_tpu_torch.main import Application
    from stellar_core_tpu_torch.main.config import test_config
    from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock

    monkeypatch.setattr(LedgerTxnRoot, "ENTRY_CACHE_SIZE", cache)
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), test_config())
    app.start()
    root = Account.root(app)
    pubs = [SecretKey(sha256(b"seam-%d" % i)).public_key().raw
            for i in range(6)]
    assert app.herder.recv_transaction(root.tx(
        [root.op_create_account(p, 10**9) for p in pubs])) == 0
    app.herder.manual_close()
    return app, pubs


@pytest.mark.parametrize("cache", [2, 8192])
def test_a_get_past_the_cache_is_a_timed_bucket_read(cache, monkeypatch):
    from stellar_core_tpu_torch.ledger import LedgerTxn

    app, pubs = _node(cache, monkeypatch)
    lm = app.ledger_manager
    lm.root.clear_entry_cache()
    assert lm.root._bucket_reads_on()
    misses0, reads0, s0 = lm.root.state_read_stats()
    buckets0 = lm.root.reads_from_buckets
    for _ in range(2):
        with LedgerTxn(lm.root) as ltx:
            for p in pubs:
                assert ltx.load_account(p) is not None
            ltx.rollback()
    misses, reads, s = lm.root.state_read_stats()
    # the second pass hits the cache unless it holds fewer than 6 entries
    want = len(pubs) * (2 if cache < len(pubs) else 1)
    assert misses - misses0 == want
    assert reads - reads0 == lm.root.reads_from_buckets - buckets0 == want
    assert s > s0
    app.graceful_stop()


def test_the_prefetch_workers_walk_counts_every_key(monkeypatch):
    """The worker's walk counts each key it read from the buckets, and
    its seconds; adopting what it found caches only what the cache
    lacked and reads nothing."""
    app, pubs = _node(8192, monkeypatch)
    root = app.ledger_manager.root
    _, reads0, s0 = root.state_read_stats()
    found = {b"\x00k%d" % i: None for i in range(3)}
    assert root.adopt_prefetch(found) == 3
    assert root.adopt_prefetch(found) == 0     # cached by now
    assert root.state_read_stats()[1:] == (reads0, s0)
    root.note_bucket_walk(3, 0.25)
    root.note_bucket_walk(3, 0.5)
    _, reads, s = root.state_read_stats()
    assert reads - reads0 == 6
    assert s - s0 == pytest.approx(0.75)
    app.graceful_stop()


def test_background_merges_are_taken_once():
    from stellar_core_tpu_torch.bucket.bucket_list import BucketList
    from stellar_core_tpu_torch.ledger.ledger_txn import account_key_bytes

    with ThreadPoolExecutor(1) as pool:
        bl = BucketList(executor=pool)
        assert bl.take_merge_stats() == 0.0
        for seq in range(1, 17):
            bl.add_batch(seq, [(account_key_bytes(b"%32d" % seq), None,
                                False)])
        staged = bl.stats["staged_merges"]
        pool.shutdown(wait=True)
        seconds = bl.take_merge_stats()
    assert staged > 0 and seconds > 0
    assert bl.take_merge_stats() == 0.0
