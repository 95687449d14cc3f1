"""A standalone validator whose ledger outgrows its entry cache, flooded
with payments, one ledger a step.

The window is ``flooded``'s: its ``prepare``, ``step``, ``after``,
``collect`` and ``judge`` are used unchanged.  Set-up differs in how the
accounts are funded.  The root cannot fund 100,000 accounts in one
ledger: a ledger takes 1,000 operations, and the queue holds four
ledgers' worth.  So set-up funds them as stellar-core's LoadGenerator
does (``generateload`` with ``mode=create``): CreateAccount transactions
of ``create_per_tx`` operations from the root, ``create_txs_per_ledger``
of them before each close, each admitted (any other status stops the
run).  Then it closes empty ledgers up to ``window_start_seq`` less the
warm-up, runs the warm-up ledgers of the cell's own traffic, and makes
the envelopes of the workload's ``pool_ledgers`` window ledgers.
"""
from __future__ import annotations

from types import SimpleNamespace

from .. import node
from ..traffic import Traffic
from .flooded import (_close, _payments, after, collect, judge,  # noqa: F401
                      prepare, step, window_close, window_open)


def setup(ctx):
    from stellar_core_tpu_torch.main import Application, Config
    from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock

    cfg, wl = ctx.config, ctx.workload
    node.use_port_defaults(cfg["port_defaults"])
    tmp = node.scratch_dir("standalone")
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                      Config(**node.node_settings(cfg, tmp)),
                      device=ctx.device)
    app.start()
    st = SimpleNamespace(app=app, tmp=tmp, records=[], phases=[],
                         envs=None, statuses=None)
    st.traffic = Traffic(ctx.seed, cfg["node"]["NETWORK_PASSPHRASE"],
                         cfg["accounts"], wl["balance"], wl["amount_max"])
    _close(ctx, st, [])                       # the upgrade of the cap
    st.next_seq = fund(ctx, st)
    while app.ledger_manager.last_closed_seq() < \
            wl["window_start_seq"] - 1 - wl["warmup_ledgers"]:
        _close(ctx, st, [])
    for _ in range(wl["warmup_ledgers"]):
        _close(ctx, st, _payments(ctx, st))
    st.pool = [_payments(ctx, st) for _ in range(wl["pool_ledgers"])]
    return st


def fund(ctx, st) -> list[int]:
    """Close ledgers of the root's CreateAccount transactions until every
    account exists; each account's next sequence number."""
    wl = ctx.workload
    creates = st.traffic.create_accounts(node.GENESIS_ROOT_SEQ,
                                         wl["create_per_tx"])
    next_seq = [0] * st.traffic.n_accounts
    per = wl["create_txs_per_ledger"]
    for lo in range(0, len(creates), per):
        _close(ctx, st, creates[lo:lo + per])
        envs, statuses, (seq,), _ = st.records[-1]
        if any(s != node.PENDING for s in statuses):
            raise RuntimeError(
                f"ledger {seq}: the node answered {statuses} to the "
                f"funding transactions; each must be admitted")
        for e in envs:
            for _, dest, _ in e.ops:
                next_seq[dest] = (seq << 32) + 1
    return next_seq
