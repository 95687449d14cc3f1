"""A standalone node's record of each ledger (``LedgerManager.
last_close_phases``): the herder's admission since the previous close,
its trigger, SCP, the SCP history's write, the close, the drain of the
close's tail, the herder's housekeeping and the database's flushes, with
the manual close's wall time and the part of it no phase holds.

The node runs on the CPU with its device paths on their plain torch
versions (``CRYPTO_BACKEND="cuda"``, ``SCP_TALLY_BACKEND="tensor"``,
``device="cpu"``), sequential and pipelined, and closes two ledgers of
``N`` payments, ``FORGED`` of them with a forged signature.

Beside it, the four modules that were copies of the JAX package's and now
time what the record holds (``tests/test_torch_node_copies.py``'s
``SEAMS``): the queue's admission stages, the host verify's misses, the
database's commits by thread, and the flight recorder's Unix clock.

Tolerance: exact counts; ms sums to the record's rounding (0.01 ms); a
span's Unix start within 5 ms of the Unix clock read at its entry.
"""
import threading
import time

import pytest

from chip_smoke import Account, forge_envelope
from stellar_core_tpu_torch.crypto import SecretKey, sha256
from stellar_core_tpu_torch.crypto import ed25519
from stellar_core_tpu_torch.database.database import Database
from stellar_core_tpu_torch.herder.herder import MANUAL_CLOSE_PHASES
from stellar_core_tpu_torch.herder.tx_queue import (ADMIT_STAGES,
                                                    TransactionQueue)
from stellar_core_tpu_torch.main import Application
from stellar_core_tpu_torch.main.config import test_config as node_config
from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock
from stellar_core_tpu_torch.utils.tracing import Tracer, chrome_trace

N, FORGED = 8, 2
PATHS = {
    "sequential": {"PIPELINED_CLOSE": False, "PARALLEL_APPLY_WORKERS": 0},
    "pipelined": {"PIPELINED_CLOSE": True, "PARALLEL_APPLY_WORKERS": 2},
}
PENDING = TransactionQueue.ADD_STATUS_PENDING


def _payments(accounts, ledger):
    """One payment from each account, amounts new in every ledger (so no
    envelope repeats one the verify cache holds), the last ``FORGED``
    forged."""
    envs = [a.tx([a.op_payment(accounts[(i + 1) % N].account_id,
                               1 + i + 100 * ledger)])
            for i, a in enumerate(accounts)]
    return envs[:N - FORGED] + [forge_envelope(e) for e in envs[N - FORGED:]]


@pytest.fixture(scope="module", params=sorted(PATHS))
def run(request):
    """The node's records: after ledger 1's close, after ledger 2's
    envelopes are admitted (before its close), after ledger 2's close.
    The host verify cache is emptied first: the other close path's node
    signed the same envelopes."""
    ed25519.clear_verify_cache()
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config(
        CRYPTO_BACKEND="cuda", SCP_TALLY_BACKEND="tensor",
        **PATHS[request.param]), device="cpu")
    app.start()
    root = Account.root(app)
    names = [b"record-%d" % i for i in range(N)]
    assert app.herder.recv_transaction(root.tx([root.op_create_account(
        SecretKey(sha256(n)).public_key().raw, 10**9)
        for n in names])) == PENDING
    app.herder.manual_close()
    accounts = [Account.named(app, n) for n in names]
    lm = app.ledger_manager
    out = {"statuses": []}
    for ledger in (1, 2):
        statuses = [app.herder.recv_transaction(e)
                    for e in _payments(accounts, ledger)]
        out["statuses"].append(statuses)
        if ledger == 2:
            out["before_close_2"] = dict(lm.last_close_phases)
        app.herder.manual_close()
        out[ledger] = dict(lm.last_close_phases)
    app.graceful_stop()
    return out


def test_forged_payments_are_refused(run):
    assert run["statuses"] == [[PENDING] * (N - FORGED) + [2] * FORGED] * 2


@pytest.mark.parametrize("ledger", [1, 2])
def test_admission_of_the_ledgers_envelopes(run, ledger):
    rec = run[ledger]
    assert rec["admit_count"] == N
    assert rec["admit_verify_count"] == N      # every envelope is fresh
    assert 0 < rec["admit_verify"] <= rec["admit"]
    stages = sum(rec[k] for k in ADMIT_STAGES)
    assert 0 < stages <= rec["admit"] + 0.01


def test_the_next_ledgers_admission_stays_out_of_the_record(run):
    """Ledger 2's envelopes, admitted after ledger 1 closed, are in
    neither ledger 1's record nor the live record before ledger 2 closes."""
    assert run["before_close_2"] == run[1]
    assert run[1]["admit_count"] == run[2]["admit_count"] == N


@pytest.mark.parametrize("ledger", [1, 2])
def test_phases_add_up_to_the_manual_close(run, ledger):
    rec = run[ledger]
    keys = MANUAL_CLOSE_PHASES + ("unattributed", "manual_close")
    assert all(rec[k] >= 0 for k in keys), {k: rec[k] for k in keys}
    assert rec["manual_close"] > 0 and rec["close_ledger"] >= rec["total"]
    parts = sum(rec[k] for k in MANUAL_CLOSE_PHASES) + rec["unattributed"]
    assert parts == pytest.approx(rec["manual_close"], abs=0.01)


@pytest.mark.parametrize("ledger", [1, 2])
def test_flushes_are_counted(run, ledger):
    rec = run[ledger]
    assert rec["db_commits"] >= 1 and rec["db_commit_ms"] >= 0
    assert isinstance(rec["db_commits"], int)


def test_the_record_starts_on_the_unix_clock(run):
    assert run[1]["t0_unix_ns"] < run[2]["t0_unix_ns"] < time.time_ns()
    assert run[2]["t0_unix_ns"] - run[1]["t0_unix_ns"] >= \
        run[1]["manual_close"] * 1e6


# -- the seams ---------------------------------------------------------------

def test_a_span_starts_on_the_unix_clock():
    tr = Tracer(enabled=True)
    wall = time.time_ns()
    with tr.span("x") as sp:
        pass
    assert abs(tr.unix_ns(sp.t0) - wall) < 5e6
    assert tr.unix_offset_ns == pytest.approx(
        time.time_ns() - time.perf_counter_ns(), abs=5e6)


def test_chrome_trace_carries_the_unix_base():
    tr = Tracer(enabled=True)
    with tr.span("root") as root:
        with tr.span("child"):
            pass
    rec = tr.commit_close(7, root)
    meta = chrome_trace(rec)["metadata"]
    assert meta["base_unix_ns"] == tr.unix_ns(root.t0)
    assert chrome_trace(rec)["traceEvents"][0]["ts"] >= 0


def test_stopwatch_laps_split_a_stretch():
    from stellar_core_tpu_torch.utils.tracing import stopwatch

    with stopwatch() as sw:
        time.sleep(0.002)
        a = sw.lap()
        b = sw.lap()
    assert a >= 0.002 and 0 <= b < a


def test_verify_misses_are_counted_and_timed():
    pk, msg = SecretKey(sha256(b"miss")), b"m" * 32
    sig = pk.sign(msg)
    n0, s0 = ed25519.verify_miss_stats()
    hits0 = ed25519.verify_cache_stats()[0]
    assert ed25519.verify_sig(pk.public_key().raw, sig, msg)
    assert ed25519.verify_sig(pk.public_key().raw, sig, msg)   # a hit
    n1, s1 = ed25519.verify_miss_stats()
    assert n1 - n0 == 1 and s1 > s0
    assert ed25519.verify_cache_stats()[0] - hits0 == 1
    ed25519.clear_verify_cache()          # the cumulative count survives
    assert ed25519.verify_miss_stats() == (n1, s1)


def test_commits_are_counted_by_thread(tmp_path):
    db = Database(str(tmp_path / "x.db"))
    db.take_commit_stats()
    db.execute("INSERT INTO persistentstate(statename, state) "
               "VALUES('a', 'b')")
    db.commit()
    seen = {}

    def other():
        db.commit()
        db.commit()
        seen["other"] = db.take_commit_stats()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    n, seconds = db.take_commit_stats()
    assert (n, seen["other"][0]) == (1, 2) and seconds >= 0
    assert db.take_commit_stats() == (0, 0.0)
    db.close()


@pytest.mark.parametrize("refused_by", ["duplicate", "sequence"])
def test_admission_stages_add_up_per_stage(refused_by):
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config())
    app.start()
    q = app.herder.tx_queue
    root = Account.root(app)
    env = root.tx([root.op_create_account(
        SecretKey(sha256(b"stages")).public_key().raw, 10**9)])
    q.take_admit_stages()
    assert q.try_add(env) == PENDING
    first = q.take_admit_stages()
    assert sorted(first) == sorted(ADMIT_STAGES)
    assert all(v > 0 for v in first.values())
    if refused_by == "duplicate":
        assert q.try_add(env) == TransactionQueue.ADD_STATUS_DUPLICATE
        want = {"admit_frame"}
    else:
        late = root.tx([root.op_create_account(
            SecretKey(sha256(b"late")).public_key().raw, 10**9)],
            seq=root.next_seq() + 5)
        assert q.try_add(late) == TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER
        want = {"admit_frame", "admit_checks"}
    again = q.take_admit_stages()
    assert {k for k, v in again.items() if v > 0} == want
    app.graceful_stop()
