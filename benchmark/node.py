"""What the drivers share: starting the port's nodes as a deployment file
states them, and reading back what a node did.  Everything here calls the
port's public entry points; nothing changes it."""
from __future__ import annotations

import hashlib
import os
import shutil
import struct
import tempfile

PENDING = 0            # TransactionQueue.ADD_STATUS_PENDING
GENESIS_SEQ = 1        # the ledger a node starts from
GENESIS_ROOT_SEQ = 0   # the root account's sequence number at genesis


def scratch_dir(label: str) -> str:
    """A directory for a run's node data (database, buckets, history
    archive, slow-close traces) under the ``TMPDIR`` the run was given;
    ``release`` removes it."""
    return tempfile.mkdtemp(prefix=f"bench-{label}-")


def release(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def use_port_defaults(names) -> None:
    """Drop environment overrides of the settings that the deployment
    leaves at the port's defaults, so that the defaults hold."""
    for name in names:
        os.environ.pop(name, None)


def node_settings(config: dict, node_dir: str) -> dict:
    """The ``Config`` keywords of a deployment file's ``node`` block, with
    ``{node_dir}`` in its paths (database, buckets, archives) standing for
    the node's own directory, which is made here."""
    def place(value):
        if isinstance(value, str):
            return value.replace("{node_dir}", node_dir)
        if isinstance(value, list):
            return [place(v) for v in value]
        return value

    kw = {k: place(v) for k, v in config["node"].items()}
    if "NODE_SEED" in kw:
        kw["NODE_SEED"] = hashlib.sha256(kw["NODE_SEED"].encode()).digest()
    if kw.get("BUCKET_DIR_PATH_REAL"):
        os.makedirs(kw["BUCKET_DIR_PATH_REAL"], exist_ok=True)
    kw["TRACE_DIR"] = os.path.join(node_dir, "traces")
    return kw


def from_pool(pool: list, i: int):
    """Window step ``i``'s traffic, made in set-up.  A window that outruns
    the pool stops the run: signing inside the window would charge the
    benchmark's own work to the program, and more to a faster program."""
    if i >= len(pool):
        raise RuntimeError(
            f"the window reached step {i + 1} and the workload's traffic "
            f"covers {len(pool)} (pool_ledgers): raise pool_ledgers")
    return pool[i]


def decode_envelope(wire: bytes):
    from stellar_core_tpu_torch.xdr import types as T

    return T.TransactionEnvelope.decode(wire)


def history(app) -> dict[bytes, tuple]:
    """Every transaction the node applied: hash -> (ledger, result code,
    fee charged), read from its ``txhistory`` rows (the result column is a
    ``TransactionResultPair``: hash, int64 fee, int32 code)."""
    out = {}
    for txid, seq, res in app.database.execute(
            "SELECT txid, ledgerseq, txresult FROM txhistory").fetchall():
        fee, code = struct.unpack(">qi", bytes(res[32:44]))
        out[bytes(txid)] = (seq, code, fee)
    return out


def accounts(app, pubs) -> list[tuple]:
    """(balance, sequence number) of each account, or None where the node
    has none."""
    from stellar_core_tpu_torch.ledger import LedgerTxn

    out = []
    with LedgerTxn(app.ledger_manager.root) as ltx:
        for pub in pubs:
            entry = ltx.load_account(pub)
            out.append(None if entry is None else
                       (entry.data.value.balance, entry.data.value.seqNum))
        ltx.rollback()
    return out


def to_next_close(app) -> None:
    """Move a standalone node's virtual clock to its next close time (the
    last one's + 1 s), as a node whose clock runs does."""
    t = app.ledger_manager.last_closed_header().scpValue.closeTime + 1
    if t > app.clock.now():
        app.clock.set_current_virtual_time(t)


def settle(sim, limit: int = 200_000) -> None:
    """Crank a simulation until a crank dispatches nothing."""
    for _ in range(limit):
        if sim.crank() == 0:
            return
    raise RuntimeError(f"the network did not settle in {limit} cranks")


def replay(records, n_accounts: int) -> tuple:
    """The plain reference over a node's records, one a ledger from the
    genesis ledger's successor on: (envelopes, the statuses the nodes
    answered, the ledger each node had closed after it, in the window or
    not).  Returns the reference ledger, the admission verdicts and the
    closed ledgers the nodes disagree with it on, the window's share of
    the first, and the last ledger."""
    from .reference.ledger import Ledger

    model = Ledger(n_accounts)
    model.root_seq = GENESIS_ROOT_SEQ
    statuses_wrong = ledgers_wrong = window_failed = 0
    seq = GENESIS_SEQ
    for envs, statuses, closed, in_window in records:
        seq += 1
        wrong = sum(model.admit(e, not e.forged) != (got == PENDING)
                    for e, got in zip(envs, statuses))
        model.close(seq)
        statuses_wrong += wrong
        ledgers_wrong += sum(c != seq for c in closed)
        window_failed += wrong if in_window else 0
    return model, statuses_wrong, ledgers_wrong, window_failed, seq


def compare_accounts(model, got, pubs) -> int:
    """Accounts whose balance or sequence number differs from the
    reference's (an account the reference holds and the node lacks
    counts)."""
    wrong = 0
    for i, row in enumerate(got):
        want = ((int(model.balance[i]), int(model.seq[i]))
                if model.exists[i] else None)
        wrong += row != want
    return wrong


def compare_history(model, got: dict) -> int:
    """Transactions whose ledger, result or fee differs from the
    reference's, that the reference applied and the node did not, or
    that the node applied and the reference did not."""
    wrong = sum(got.get(h) != want for h, want in model.results.items())
    return wrong + sum(h not in model.results for h in got)


def sample_disagrees(envs, seed: int, per_kind: int) -> int:
    """Signatures, of a sample drawn from the seed (``per_kind`` forged
    and ``per_kind`` sound envelopes), on which the plain reference's
    verify disagrees with what the traffic made."""
    import numpy as np

    from .reference import ed25519 as ref

    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    out = 0
    for forged in (True, False):
        pool = [e for e in envs if e.forged == forged]
        if not pool:
            continue
        pick = rng.choice(len(pool), min(per_kind, len(pool)), replace=False)
        for k in pick.tolist():
            e = pool[k]
            out += ref.verify(e.pub, e.sig, e.hash) == e.forged
    return out
