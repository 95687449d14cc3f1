"""A standalone validator flooded with payments, one ledger a step.

Set-up starts the node as the deployment file states it, closes the
ledger whose upgrade raises the operation cap, funds the seeded accounts
(the root's CreateAccount transactions, admitted and closed like any
others), closes empty ledgers up to the workload's ``window_start_seq``
less its warm-up, and runs the warm-up ledgers of the cell's own traffic,
so that every kernel and native library is built and every path taken
before the window opens at the same ledger in every run.  It also makes
the envelopes of the workload's ``pool_ledgers`` window ledgers; a window
that outruns them stops the run.

A step is one ledger of the node's work: every envelope of the ledger,
decoded from its wire bytes and handed to ``herder.recv_transaction``
(span ``admit``), then ``herder.manual_close`` (span ``close``).  Each
ledger holds one payment from every seeded account, in an order drawn
from the seed, ``forged_per_ledger`` of them with a forged signature.
"""
from __future__ import annotations

from types import SimpleNamespace

from .. import node
from ..traffic import Traffic


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
    _close(ctx, st, st.traffic.create_accounts(node.GENESIS_ROOT_SEQ))
    created = node.GENESIS_SEQ + 2
    st.next_seq = [(created << 32) + 1] * st.traffic.n_accounts
    while app.ledger_manager.last_closed_seq() < \
            wl["window_start_seq"] - 1 - wl["warmup_ledgers"]:
        _close(ctx, st, [])
    for _ in range(wl["warmup_ledgers"]):
        _close(ctx, st, _payments(ctx, st))
    st.pool = [_payments(ctx, st) for _ in range(wl["pool_ledgers"])]
    return st


def _payments(ctx, st):
    wl = ctx.workload
    return st.traffic.ledger(st.next_seq, wl["per_ledger"],
                             wl["forged_per_ledger"])


def _submit(st, envs) -> list[int]:
    recv = st.app.herder.recv_transaction
    return [recv(node.decode_envelope(e.wire)) for e in envs]


def _close(ctx, st, envs) -> None:
    """A ledger outside the window: submit, close, record."""
    statuses = _submit(st, envs)
    node.to_next_close(st.app)
    st.app.herder.manual_close()
    ctx.sync()
    st.records.append((envs, statuses,
                       [st.app.ledger_manager.last_closed_seq()], False))


def window_open(ctx, st) -> None:
    pass


def prepare(ctx, st, i) -> None:
    st.envs = node.from_pool(st.pool, i)


def step(ctx, st, i) -> None:
    with ctx.span("admit"):
        st.statuses = _submit(st, st.envs)
    with ctx.span("close"):
        node.to_next_close(st.app)
        st.app.herder.manual_close()
        ctx.sync()


def after(ctx, st, i) -> None:
    st.records.append((st.envs, st.statuses,
                       [st.app.ledger_manager.last_closed_seq()], True))
    st.phases.append(dict(st.app.ledger_manager.last_close_phases))
    ctx.attempted += len(st.envs)


def window_close(ctx, st) -> None:
    ctx.counters["close_phases"] = st.phases


def collect(ctx, st) -> dict:
    pubs = st.traffic.keys.public
    out = {"records": st.records, "history": node.history(st.app),
           "accounts": node.accounts(st.app, pubs),
           "root_seq": node.accounts(st.app, [st.traffic.root_pub])[0][1],
           "pubs": pubs}
    st.app.graceful_stop()
    node.release(st.tmp)
    return out


def judge(ctx, out) -> dict:
    """The node against the plain reference, ledger by ledger: admission,
    the applied set with each result and fee, the ledger each closed, and
    every account's balance and sequence number."""
    model, statuses_wrong, ledgers_wrong, window_failed, _ = node.replay(
        out["records"], len(out["pubs"]))
    results_wrong = node.compare_history(model, out["history"])
    accounts_wrong = node.compare_accounts(model, out["accounts"],
                                           out["pubs"])
    accounts_wrong += out["root_seq"] != model.root_seq
    window_envs = [e for envs, _, _, w in out["records"] if w for e in envs]
    ctx.failed = window_failed + results_wrong
    return {
        "statuses_wrong": (statuses_wrong, 0),
        "results_wrong": (results_wrong, 0),
        "accounts_wrong": (accounts_wrong, 0),
        "ledgers_wrong": (ledgers_wrong, 0),
        "reference_disagrees": (node.sample_disagrees(
            window_envs, ctx.seed, ctx.workload["sample_per_kind"]), 0),
    }
