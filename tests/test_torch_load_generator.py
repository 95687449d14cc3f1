"""The port's ``LoadGenerator`` (a copy of the JAX package's) held against
the JAX one on equally seeded nodes: the same accounts, entries and
envelope bytes for ``create_accounts``, ``generate_payments``,
``setup_dex`` and ``generate_mixed`` (and their transaction-based
seeding), and the same ledger hash when both nodes close what their
generators made; then ``tests/test_loadgen_rate.py``'s non-slow cases, run
on the port as the very code of that file with the package's dotted name
``stellar_core_tpu.`` written ``stellar_core_tpu_torch.``.

Tolerance: byte equality.
"""
from pathlib import Path

import pytest

from stellar_core_tpu.ledger.ledger_txn import LedgerTxn as JLedgerTxn
from stellar_core_tpu.main import Application as JApplication
from stellar_core_tpu.main import test_config as j_test_config
from stellar_core_tpu.simulation.load_generator import \
    LoadGenerator as JLoadGenerator
from stellar_core_tpu.utils.clock import ClockMode as JClockMode
from stellar_core_tpu.utils.clock import VirtualClock as JVirtualClock
from stellar_core_tpu.xdr import types as JT
from stellar_core_tpu_torch.ledger.ledger_txn import LedgerTxn
from stellar_core_tpu_torch.main import Application
from stellar_core_tpu_torch.main import test_config as node_config
from stellar_core_tpu_torch.simulation.load_generator import LoadGenerator
from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock
from stellar_core_tpu_torch.xdr import types as T

from .test_torch_golden import _as_port_module

TESTS = Path(__file__).resolve().parent
RATE_CASES = ("test_rate_run_submits_at_rate", "test_rate_run_stop_route",
              "test_rate_requires_accounts")


def _pair():
    """A started JAX node and port node of the same config (host tiers),
    each with its generator."""
    ja = JApplication(JVirtualClock(JClockMode.VIRTUAL_TIME),
                      j_test_config(TESTING_UPGRADE_MAX_TX_SET_SIZE=500))
    pa = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                     node_config(TESTING_UPGRADE_MAX_TX_SET_SIZE=500))
    for app in (ja, pa):
        app.start()
    return (ja, JLoadGenerator(ja), JT), (pa, LoadGenerator(pa), T)


def _bytes(types, envs) -> list:
    return [types.TransactionEnvelope.encode(e) for e in envs]


def _close_both(pair, envs_of) -> None:
    """Each node receives its generator's envelopes and closes; the
    statuses and the new ledger hashes must be equal."""
    statuses, hashes = [], []
    for app, _, _ in pair:
        statuses.append([app.herder.recv_transaction(e)
                         for e in envs_of[id(app)]])
        app.herder.manual_close()
        hashes.append(app.ledger_manager.last_closed_hash())
    assert statuses[0] == statuses[1] and set(statuses[0]) == {0}
    assert hashes[0] == hashes[1]


def _root_entries(app, ltx_cls, types, keys) -> list:
    with ltx_cls(app.ledger_manager.root) as ltx:
        out = [types.LedgerEntry.encode(ltx.load_account(k)) for k in keys]
        ltx.rollback()
    return out


def test_bulk_seeding_payments_and_mixed_equal_jax():
    pair = _pair()
    (ja, jlg, _), (pa, plg, _) = pair
    jkeys, pkeys = (lg.create_accounts(40) for lg in (jlg, plg))
    assert [k.public_key().raw for k in jkeys] == \
        [k.public_key().raw for k in pkeys]
    raws = [k.public_key().raw for k in pkeys]
    assert _root_entries(ja, JLedgerTxn, JT, raws) == \
        _root_entries(pa, LedgerTxn, T, raws)

    envs = {id(app): lg.generate_payments(60) for app, lg, _ in pair}
    assert _bytes(JT, envs[id(ja)]) == _bytes(T, envs[id(pa)])
    _close_both(pair, envs)

    for _, lg, _ in pair:
        lg.setup_dex()
    assert JT.Asset.encode(jlg.dex_asset) == T.Asset.encode(plg.dex_asset)
    issuer = plg.dex_issuer.public_key().raw
    assert _root_entries(ja, JLedgerTxn, JT, raws + [issuer]) == \
        _root_entries(pa, LedgerTxn, T, raws + [issuer])
    for pct in (30, 50):
        envs = {id(app): lg.generate_mixed(60, dex_percent=pct)
                for app, lg, _ in pair}
        assert _bytes(JT, envs[id(ja)]) == _bytes(T, envs[id(pa)])
        _close_both(pair, envs)


def test_transaction_seeding_equals_jax():
    """The generators' real-transaction seeding (CREATE_ACCOUNT from the
    root, the DEX issuer, the trust lines and their funding) gives the
    same bytes, and both nodes close it to the same hash."""
    pair = _pair()
    (ja, jlg, _), (pa, plg, _) = pair
    envs = {id(app): lg.create_account_envelopes(30, batch=10)
            for app, lg, _ in pair}
    assert _bytes(JT, envs[id(ja)]) == _bytes(T, envs[id(pa)])
    _close_both(pair, envs)
    for stage in ("create_dex_issuer_envelope", "setup_dex_envelopes",
                  "fund_dex_envelopes"):
        envs = {id(app): getattr(lg, stage)() for app, lg, _ in pair}
        assert _bytes(JT, envs[id(ja)]) == _bytes(T, envs[id(pa)]), stage
        _close_both(pair, envs)


@pytest.fixture(scope="module")
def rate_module():
    return _as_port_module("torch_loadgen_rate",
                           TESTS / "test_loadgen_rate.py")


def test_rate_module_runs_on_the_port(rate_module):
    assert rate_module.LoadGenerator is LoadGenerator
    assert rate_module.CommandHandler.__module__ == \
        "stellar_core_tpu_torch.main.http_server"


@pytest.mark.parametrize("name", RATE_CASES)
def test_loadgen_rate_case_on_the_port(rate_module, name):
    getattr(rate_module, name)()
