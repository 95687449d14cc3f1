"""The port's standalone node held against the JAX package's, in one
process (the JAX side runs as its own tests run it, on the CPU).

1. Genesis: the same first header and LCL hash for the same config.
2. Replay: the JAX node runs ``tests/test_apply_determinism.py``'s
   workload (create 30; mixed 60 three times; mixed 60 at dexpct 45 four
   times) through its ``generateload`` endpoint, its herder's
   ``recv_transaction`` recorded; the port's node receives the same
   envelopes in the same order and closes at the same points.  Every close
   gives the same statuses, ledger hash, bucket-list hash,
   ``LedgerCloseMeta`` bytes and ``txhistory`` rows — sequentially and
   with the pipelined close and 2 parallel-apply workers on the port.
3. The batch path: ``CRYPTO_BACKEND="cuda"`` on ``device="cpu"`` (the
   verify wrapper then runs its plain torch version) over the first two
   closes, then a peer's tx set of payments with every 8th signature
   forged, closed through ``close_ledger`` in both packages with the same
   ``StellarValue``: one batch verify a close, forged txs ``txBAD_AUTH``
   with their fee charged, the same bytes.  Batches stay at 256 rows (the
   plain version takes seconds per batch on a CPU).
4. ``tests/test_standalone_node.py``'s 13 cases on the port's node.
5. The native tiers build under ``build/torch_native/`` and serve the
   close; the config refuses ``"tpu"``; device backends without a GPU or a
   ``device`` raise.

Tolerance: byte equality everywhere.
"""
from pathlib import Path

import pytest
import torch

from chip_smoke import (Account, CloseProbe, close_peer_set, close_results,
                        forge_envelope, node_state)
from stellar_core_tpu.herder.tx_set import TxSetFrame as JTxSetFrame
from stellar_core_tpu.ledger.ledger_manager import \
    LedgerCloseData as JLedgerCloseData
from stellar_core_tpu.main import Application as JApplication
from stellar_core_tpu.main import test_config as j_test_config
from stellar_core_tpu.main.http_server import CommandHandler
from stellar_core_tpu.utils.clock import ClockMode as JClockMode
from stellar_core_tpu.utils.clock import VirtualClock as JVirtualClock
from stellar_core_tpu.xdr import types as JT
from stellar_core_tpu_torch import native
from stellar_core_tpu_torch.crypto import SecretKey, sha256
from stellar_core_tpu_torch.herder.herder import SCP_EXTRA_LOOKBACK_LEDGERS
from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
from stellar_core_tpu_torch.ledger import LedgerTxn
from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
from stellar_core_tpu_torch.main import Application, Config
from stellar_core_tpu_torch.main.config import ConfigError
from stellar_core_tpu_torch.main.config import test_config as node_config
from stellar_core_tpu_torch.transactions.frame import tx_frame_from_envelope
from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock
from stellar_core_tpu_torch.xdr import runtime
from stellar_core_tpu_torch.xdr import types as T

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "stellar_core_tpu_torch"

WORKLOAD = ([{"mode": "create", "accounts": "30"}]
            + [{"mode": "mixed", "txs": "60"}] * 3
            + [{"mode": "mixed", "txs": "60", "dexpct": "45"}] * 4)
SEQUENTIAL = {"PARALLEL_APPLY_WORKERS": 0, "PIPELINED_CLOSE": False}
NODE_CONFIGS = {
    "sequential": SEQUENTIAL,
    "pipelined_parallel": {"PARALLEL_APPLY_WORKERS": 2,
                           "PIPELINED_CLOSE": True},
}


def jax_app():
    app = JApplication(JVirtualClock(JClockMode.VIRTUAL_TIME),
                       j_test_config(TESTING_UPGRADE_MAX_TX_SET_SIZE=200,
                                     **SEQUENTIAL))
    app.start()
    return app


def port_app(device=None, **kw):
    kw = {**SEQUENTIAL, **kw}
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                      node_config(TESTING_UPGRADE_MAX_TX_SET_SIZE=200, **kw),
                      device=device)
    app.start()
    return app


@pytest.fixture(scope="module")
def jax_run():
    """The JAX node over the workload: per close, the envelopes its herder
    received (bytes, in order) with their statuses, and its fingerprint."""
    app = jax_app()
    handler = CommandHandler(app)
    received = []
    real = app.herder.recv_transaction

    def recording(env):
        status = real(env)
        received.append((JT.TransactionEnvelope.encode(env), status))
        return status

    app.herder.recv_transaction = recording
    closes = []
    for params in WORKLOAD:
        code, body = handler.handle("generateload", params)
        assert code == 200, body
        app.herder.manual_close()
        closes.append((list(received), node_state(app, JT)))
        received.clear()
    app.graceful_stop()
    return closes


def replay(app, closes, label=""):
    """Feed the port node ``app`` each close's envelopes, close, and hold
    every close to the JAX node's."""
    for i, (envelopes, want) in enumerate(closes):
        got = [app.herder.recv_transaction(T.TransactionEnvelope.decode(b))
               for b, _ in envelopes]
        assert got == [status for _, status in envelopes], (label, i)
        app.herder.manual_close()
        have = node_state(app, T)
        for key in want:
            assert have[key] == want[key], f"{label} close {i}: {key}"


# -- 1. genesis -------------------------------------------------------------

def test_genesis_equals_jax():
    j, p = jax_app(), port_app()
    assert JT.LedgerHeader.encode(j.ledger_manager.last_closed_header()) \
        == T.LedgerHeader.encode(p.ledger_manager.last_closed_header())
    assert j.ledger_manager.last_closed_hash() == \
        p.ledger_manager.last_closed_hash()


# -- 2. replay of the mixed / DEX workload ------------------------------------

@pytest.mark.parametrize("name", sorted(NODE_CONFIGS))
def test_replay_equals_jax(jax_run, name):
    assert len(jax_run) >= 8
    # the DEX closes carry offers
    offer = JT.OperationType.MANAGE_SELL_OFFER
    assert all(any(op.body.type == offer
                   for b, _ in envs
                   for op in JT.TransactionEnvelope.decode(b).value.tx
                   .operations) for envs, _ in jax_run[4:])
    app = port_app(**NODE_CONFIGS[name])
    replay(app, jax_run, name)
    if name == "pipelined_parallel":
        assert app.ledger_manager.pipeline.enabled
        assert app.parallel_apply.enabled
    app.graceful_stop()


def test_native_tiers_build_outside_the_package_and_serve_the_close(
        jax_run):
    app = port_app()
    replay(app, jax_run[:3])
    build = REPO / "build" / "torch_native"
    # the bucket-merge library is built on first use, which three closes
    # need not reach: build it here, so that the check does not rest on
    # another test file having built it first
    native.get_lib()
    xdrpack = native.extension_path("_xdrpack", native.XDRPACK_SOURCE)
    apply_kernel = native.extension_path("_applykernel",
                                         native.APPLY_SOURCE)
    for path in (native.library_path(), xdrpack, apply_kernel):
        assert path.parent == build and path.exists(), path
    assert native.get_xdrpack().__file__ == str(xdrpack)
    assert runtime._native_pack is native.get_xdrpack().pack
    assert native.get_apply_kernel().__file__ == str(apply_kernel)
    assert T.NATIVE_ENCODE
    # sources only: the linter's two committed data files aside
    data = {PORT / "tools" / "lint" / name
            for name in ("lockstep.json", "baseline.json")}
    built_here = [p for p in PORT.rglob("*") if p.is_file()
                  and "__pycache__" not in p.parts and p not in data
                  and p.suffix not in (".py", ".c", ".cpp", ".cu")]
    assert not built_here, built_here
    for name in ("apply.native.fee.hit", "apply.native.tail_encode.hit"):
        assert app.metrics.counter(name).count > 0, name
    app.graceful_stop()


# -- 3. the batch path on the CPU ---------------------------------------------

def test_batch_path_on_cpu_equals_jax(jax_run):
    j = jax_app()
    p = port_app(device="cpu", CRYPTO_BACKEND="cuda")
    assert p.device == torch.device("cpu")
    with CloseProbe(p) as probe:
        for envelopes, want in jax_run[:2]:
            for b, status in envelopes:
                assert j.herder.recv_transaction(
                    JT.TransactionEnvelope.decode(b)) == status
            j.herder.manual_close()
            probe.reset()
            replay(p, [(envelopes, want)], "batch")
            assert node_state(j, JT) == want
            assert probe.batches == [256] and probe.host_verifies == 0
            assert len(probe.answered) == len(envelopes)
        # a peer's set: one payment from each load-generator account, every
        # 8th with a flipped signature byte
        accounts = [Account.named(p, b"loadgen-%d" % i) for i in range(30)]
        envs = [a.tx([a.op_payment(accounts[(i + 1) % 30].account_id,
                                   1 + i)]) for i, a in enumerate(accounts)]
        envs = [forge_envelope(e) if i % 8 == 7 else e
                for i, e in enumerate(envs)]
        probe.reset()
        tx_set = close_peer_set(p, T, TxSetFrame, LedgerCloseData, envs)
        close_peer_set(j, JT, JTxSetFrame, JLedgerCloseData,
                   [JT.TransactionEnvelope.decode(
                       T.TransactionEnvelope.encode(e)) for e in envs])
    assert probe.batches == [256] and probe.host_verifies == 0
    assert len(probe.answered) == 30
    assert node_state(p, T) == node_state(j, JT)
    net_id = p.config.network_id()
    forged = {tx_frame_from_envelope(net_id, envs[i]).full_hash()
              for i in range(7, 30, 8)}
    results = close_results(p)
    order = tx_set.txs_in_apply_order()
    assert [code for code, _ in results] == [
        "txBAD_AUTH" if f.full_hash() in forged else "txSUCCESS"
        for f in order]
    assert sum(code == "txBAD_AUTH" for code, _ in results) == 3
    assert all(fee == 100 for _, fee in results)


# -- 4. tests/test_standalone_node.py's cases on the port's node ------------

@pytest.fixture()
def app():
    a = Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config())
    a.start()
    return a


def load_account(app, account_id):
    with LedgerTxn(app.ledger_manager.root) as ltx:
        e = ltx.load_account(account_id)
        ltx.rollback()
    return e


def create_env(root, name: bytes, balance=10**9, **kw):
    dest = SecretKey(sha256(name)).public_key().raw
    return root.tx([root.op_create_account(dest, balance)], **kw)


def test_boot_creates_genesis(app):
    info = app.get_json_info()
    assert info["ledger"]["num"] == 1
    assert info["state"] == "Synced!"


def test_manual_close_advances_empty_ledgers(app):
    h0 = app.ledger_manager.last_closed_hash()
    assert app.herder.manual_close() == 2
    assert app.herder.manual_close() == 3
    assert app.ledger_manager.last_closed_hash() != h0
    assert app.ledger_manager.last_closed_header().ledgerSeq == 3


def test_submit_and_close_payment(app):
    root = Account.root(app)
    dest = SecretKey(sha256(b"node-dest")).public_key().raw
    env = root.tx([root.op_create_account(dest, 10**9)])
    assert app.herder.recv_transaction(env) == \
        TransactionQueue.ADD_STATUS_PENDING
    assert app.herder.tx_queue.size() == 1
    app.herder.manual_close()
    e = load_account(app, dest)
    assert e is not None and e.data.value.balance == 10**9
    assert app.herder.tx_queue.size() == 0


def test_duplicate_submission_rejected(app):
    env = create_env(Account.root(app), b"node-dup")
    assert app.herder.recv_transaction(env) == \
        TransactionQueue.ADD_STATUS_PENDING
    assert app.herder.recv_transaction(env) == \
        TransactionQueue.ADD_STATUS_DUPLICATE


def test_seq_gap_try_again_later(app):
    root = Account.root(app)
    env = create_env(root, b"node-gap", seq=root.next_seq() + 5)
    assert app.herder.recv_transaction(env) == \
        TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER


def test_chained_txs_one_ledger(app):
    root = Account.root(app)
    seq = root.next_seq()
    assert app.herder.recv_transaction(
        create_env(root, b"chain-a", seq=seq)) == 0
    assert app.herder.recv_transaction(
        create_env(root, b"chain-b", seq=seq + 1)) == 0
    app.herder.manual_close()
    for name in (b"chain-a", b"chain-b"):
        assert load_account(
            app, SecretKey(sha256(name)).public_key().raw) is not None


def test_bucket_list_hash_advances_and_is_deterministic():
    def run():
        a = Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config())
        a.start()
        a.herder.recv_transaction(create_env(Account.root(a), b"det-dest"))
        a.herder.manual_close()
        return (a.ledger_manager.last_closed_hash(),
                a.bucket_manager.get_bucket_list_hash())

    (h1, b1), (h2, b2) = run(), run()
    assert h1 == h2 and b1 == b2
    assert b1 != b"\x00" * 32


def test_tx_history_rows_written(app):
    app.herder.recv_transaction(create_env(Account.root(app), b"hist-dest"))
    app.herder.manual_close()
    rows = app.database.execute(
        "SELECT ledgerseq, txindex FROM txhistory").fetchall()
    assert rows == [(2, 0)]


def test_meta_stream_emitted(app):
    app.herder.recv_transaction(create_env(Account.root(app), b"meta-dest"))
    app.herder.manual_close()
    meta = app._meta_stream[-1].value
    assert meta.ledgerHeader.header.ledgerSeq == 2
    assert len(meta.txProcessing) == 1
    b = T.LedgerCloseMeta.encode(app._meta_stream[-1])
    assert T.LedgerCloseMeta.decode(b) is not None


def test_invariants_run_during_close(app):
    app.herder.recv_transaction(create_env(Account.root(app), b"inv-dest"))
    app.herder.manual_close()  # would raise InvariantDoesNotHold on breach
    assert app.invariants.invariants


def test_queue_limiter_evicts_cheapest(app):
    """The global mempool cap: a higher-fee tx evicts the cheapest tail, a
    lower-or-equal one is refused, a tx never breaks its own chain, and a
    newcomer that cannot fully fit leaves the queue untouched."""
    root = Account.root(app)
    q = app.herder.tx_queue
    net_id = app.config.network_id()
    app.config.TRANSACTION_QUEUE_SIZE_MULTIPLIER = 0
    assert app.herder.recv_transaction(
        create_env(root, b"lim-a", 10**10)) == \
        TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER
    app.config.TRANSACTION_QUEUE_SIZE_MULTIPLIER = 4
    accs = []
    for i in range(3):
        acct = Account.named(app, b"lim-%d" % i)
        assert app.herder.recv_transaction(root.tx([root.op_create_account(
            acct.account_id, 10**10)])) == 0
        app.herder.manual_close()
        accs.append(acct)

    q._capacity_ops = lambda: 2
    dest = root.account_id
    cheap = accs[0].tx([accs[0].op_payment(dest, 1)], fee=100)
    mid = accs[1].tx([accs[1].op_payment(dest, 1)], fee=150)
    assert app.herder.recv_transaction(cheap) == 0
    assert app.herder.recv_transaction(mid) == 0
    assert q.size() == 2
    low = accs[2].tx([accs[2].op_payment(dest, 1)], fee=100)
    assert app.herder.recv_transaction(low) == \
        TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER
    rich = accs[2].tx([accs[2].op_payment(dest, 1)], fee=500)
    assert app.herder.recv_transaction(rich) == 0
    assert q.size() == 2
    assert q.is_banned(tx_frame_from_envelope(net_id, cheap).full_hash())

    tail_seq = q.accounts[accs[2].account_id].frames[-1].seq_num()
    rich2 = accs[2].tx([accs[2].op_payment(dest, 1)], fee=9999,
                       seq=tail_seq + 1)
    assert app.herder.recv_transaction(rich2) == 0
    assert q.size() == 2
    assert len(q.accounts[accs[2].account_id].frames) == 2
    assert q.is_banned(tx_frame_from_envelope(net_id, mid).full_hash())

    acct4 = Account.named(app, b"lim-4")
    del q._capacity_ops
    assert app.herder.recv_transaction(root.tx([root.op_create_account(
        acct4.account_id, 10**10)])) == 0
    app.herder.manual_close()
    q._capacity_ops = lambda: 2
    c1 = accs[0].tx([accs[0].op_payment(dest, 1)], fee=400)
    c2 = accs[1].tx([accs[1].op_payment(dest, 1)], fee=100)
    assert app.herder.recv_transaction(c1) == 0
    assert app.herder.recv_transaction(c2) == 0
    big = acct4.tx([acct4.op_payment(dest, 1), acct4.op_payment(dest, 2)],
                   fee=400)
    assert app.herder.recv_transaction(big) == \
        TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER
    assert q.size() == 2
    assert not q.is_banned(tx_frame_from_envelope(net_id, c2).full_hash())


def test_tx_set_retention_bounded(app):
    pe = app.herder.pending_envelopes
    for _ in range(20):
        app.herder.manual_close()
    window = max(SCP_EXTRA_LOOKBACK_LEDGERS,
                 app.config.MAX_SLOTS_TO_REMEMBER)
    assert len(pe.tx_sets) <= window + 1, len(pe.tx_sets)
    assert len(pe._tx_set_seen) == len(pe.tx_sets)
    assert pe.pending == {}


def test_tx_set_retention_follows_referencing_slot(app):
    from types import SimpleNamespace

    pe = app.herder.pending_envelopes
    lm = app.ledger_manager
    future_slot = lm.last_closed_seq() + 40
    ts = TxSetFrame(app.config.network_id(), lm.last_closed_hash(), [])
    h = ts.contents_hash()
    pe.pending[h] = []
    pe.add_tx_set(ts)
    pe.note_referenced(h, future_slot)
    window = max(SCP_EXTRA_LOOKBACK_LEDGERS,
                 app.config.MAX_SLOTS_TO_REMEMBER)
    pe.prune_below(future_slot - 5)
    assert h in pe.tx_sets
    pe.prune_below(future_slot + window)
    assert h not in pe.tx_sets

    ts2 = TxSetFrame(app.config.network_id(), b"\x01" * 32, [])
    h2 = ts2.contents_hash()
    env = SimpleNamespace(statement=SimpleNamespace(
        slotIndex=future_slot, nodeID=None))
    pe.pending[h2] = [env]
    delivered = []
    app.herder.deliver_ready_envelope = lambda e: delivered.append(e)
    pe.add_tx_set(ts2)
    assert delivered == [env]
    assert pe._tx_set_seen[h2] == future_slot


# -- 5. config and device -----------------------------------------------------

def test_tpu_backend_refused():
    with pytest.raises(ConfigError, match='"cuda"'):
        Config(CRYPTO_BACKEND="tpu").validate()
    a = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                    node_config(CRYPTO_BACKEND="tpu"))
    with pytest.raises(ConfigError, match="tpu"):
        a.start()


@pytest.mark.parametrize("kw", [{"CRYPTO_BACKEND": "cuda"},
                                {"CRYPTO_BACKEND": "auto"},
                                {"SCP_TALLY_BACKEND": "tensor"},
                                {"SCP_TALLY_BACKEND": "auto"}],
                         ids=["crypto-cuda", "crypto-auto", "tally-tensor",
                              "tally-auto"])
def test_device_backend_without_gpu_raises(kw):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Application(VirtualClock(ClockMode.VIRTUAL_TIME), node_config(**kw))
    # a host-backend node needs no device
    assert Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                       node_config()).device is None
