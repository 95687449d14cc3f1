"""Deterministic node workloads that the tools' parity passes replay: the
port's own copies of two functions of the repository's tests,
``tests/test_pipelined_close.py::run_workload`` and
``tests/test_txtrace.py::run_telemetry_workload``.  Each also takes the
node's ``device``; the node's backends come with the other settings
(``test_config`` pins the host tiers)."""
from ..main import Application, test_config
from ..main.http_server import CommandHandler
from ..utils.clock import ClockMode, VirtualClock
from ..xdr import types as T


def _mk_app(device=None, **kw):
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), test_config(
        TESTING_UPGRADE_MAX_TX_SET_SIZE=200, **kw), device=device)
    app.start()
    return app


def run_workload(pipelined, eager=None, dex=True, device=None, **kw):
    """Deterministic mixed workload through the full node close path;
    returns per-close (ledger hash, bucket hash, meta bytes)
    fingerprints and the close pipeline's stats.  With ``eager=False``
    the tail genuinely overlaps the next close's admission + close work;
    fingerprints are read from memory (always current) and the meta
    stream after a final drain."""
    app = _mk_app(device, PIPELINED_CLOSE=pipelined,
                  PIPELINED_CLOSE_EAGER_DRAIN=eager, **kw)
    handler = CommandHandler(app)
    hashes = []

    def close():
        app.herder.manual_close()
        hashes.append((app.ledger_manager.last_closed_hash(),
                       app.bucket_manager.get_bucket_list_hash()))

    code, body = handler.handle("generateload",
                                {"mode": "create", "accounts": "24"})
    assert code == 200, body
    close()
    for _ in range(2):  # issuer, trustlines, funding
        code, body = handler.handle("generateload",
                                    {"mode": "mixed", "txs": "48"})
        assert code == 200, body
        close()
    for _ in range(3):
        params = {"mode": "mixed", "txs": "48"}
        if dex:
            params["dexpct"] = "40"
        code, body = handler.handle("generateload", params)
        assert code == 200, body
        close()
    app.ledger_manager.pipeline.drain()
    metas = [T.LedgerCloseMeta.encode(m) for m in app._meta_stream]
    stats = dict(app.ledger_manager.pipeline.stats)
    app.graceful_stop()
    assert len(metas) == len(hashes)
    return [h + (m,) for h, m in zip(hashes, metas)], stats


def run_telemetry_workload(telemetry: bool, pipelined: bool = False,
                           device=None, **kw):
    """Deterministic mixed workload through the full close path with
    the lifecycle tracker + vitals sampling on or off; returns per-close
    (ledger hash, bucket hash, meta bytes)."""
    app = _mk_app(
        device,
        TX_LIFECYCLE_TRACKING=telemetry,
        PIPELINED_CLOSE=pipelined,
        PIPELINED_CLOSE_EAGER_DRAIN=False if pipelined else None,
        **kw)
    handler = CommandHandler(app)
    out = []

    def close():
        if telemetry:
            app.vitals.sample_once()
        app.herder.manual_close()
        out.append((app.ledger_manager.last_closed_hash(),
                    app.bucket_manager.get_bucket_list_hash()))

    code, body = handler.handle("generateload",
                                {"mode": "create", "accounts": "20"})
    assert code == 200, body
    close()
    for _ in range(2):  # issuer, trustlines, funding
        code, body = handler.handle("generateload",
                                    {"mode": "mixed", "txs": "40"})
        assert code == 200, body
        close()
    for _ in range(3):
        code, body = handler.handle(
            "generateload", {"mode": "mixed", "txs": "40",
                             "dexpct": "40"})
        assert code == 200, body
        close()
    app.ledger_manager.pipeline.drain()
    metas = [T.LedgerCloseMeta.encode(m) for m in app._meta_stream]
    app.graceful_stop()
    assert len(metas) == len(out)
    return [h + (m,) for h, m in zip(out, metas)]


def identical(a: list, b: list) -> bool:
    """Equal per-close (ledger hash, bucket hash, meta bytes) rows."""
    return len(a) == len(b) and all(
        ra[:3] == rb[:3] for ra, rb in zip(a, b))
