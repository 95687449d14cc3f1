"""Catchup bench on the port: a cold node joins a LIVE simulated network,
trailing it by the whole seeded range, while closes keep arriving — the
counterpart of the repository's ``tools/catchup_bench.py``.

Three phases:
  1. seed    — a core-2 validator network (``cpu`` / ``host`` backends)
               closes ledgers carrying ``--entries`` create-account
               entries, ``--per-close`` a ledger, through real
               transactions of 100 ops each (so complete-mode replay
               reproduces bit-identical buckets), and publishes
               checkpoints to a local archive.
  2. minimal — a cold node joins mid-traffic and catches up via verified
               bucket apply + buffered-live-ledger drain: time-to-synced,
               bucket-apply MB/s, verify/apply/replay phase split.
  3. complete — a second cold node joins with CATCHUP_COMPLETE=True and
               replays every ledger from genesis: ledgers/s replayed, the
               close's verify phase, and the verify kernel's launches.
Both joiners run ``--joiner-backend`` (``cuda``: every replayed ledger's
signatures as one batch on the device, tallies ``tensor``; ``cpu``: host
verifies, tallies ``host``), so the card's replay rate and the host's come
from the same code (the process's host verify cache is emptied before
each join, as a fresh node's is); both must end bit-identical (header
hash + bucketListHash, every shared seq) to the validators.  A run
without ``--smoke`` must also trail by >= 1,000 ledgers and see minimal
catchup beat complete by >= 5x; the result's ``gates_checked`` says
whether these gates were held.

Prints one JSON line a phase and the result as the last line; writes the
result to a file only with ``--out``.  The joiners run on the GPU unless
``--device cpu`` is given (tests): then every node, the joiners too, runs
the host tiers, and ``--joiner-backend`` can only be ``cpu``.

Usage: python -m stellar_core_tpu_torch.tools.catchup_bench [--smoke]
           [--entries N] [--per-close N] [--joiner-backend cuda|cpu]
           [--out PATH] [--device cpu]
"""
import argparse
import json
import os
import resource
import sys
import tempfile
import time

from . import add_device_arg, no_gpu, node_kw

PROG = "python -m stellar_core_tpu_torch.tools.catchup_bench"
FULL_TIER_ENTRIES = 1_000_000
HOST = {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def emit(line: dict) -> None:
    print(json.dumps(line, sort_keys=True), flush=True)


def run(n_entries: int, per_close: int, joiner_backend: str, device,
        work_dir: str, smoke: bool) -> dict:
    """The three phases on ``device`` (the joiners' device when they run
    ``cuda``); returns the result."""
    from ..crypto import SecretKey, sha256
    from ..crypto.ed25519 import clear_verify_cache
    from ..ops import ed25519_cuda
    from ..simulation.load_generator import LoadGenerator
    from ..simulation.simulation import Simulation
    from ..xdr import types as T

    arch_dir = os.path.join(work_dir, "archive")
    sim = Simulation(network_passphrase="catchup bench network",
                     device=device)
    seeds = [sha256(b"catchup-bench-%d" % i) for i in range(2)]
    ids = [SecretKey(s).public_key().raw for s in seeds]
    qset = {"threshold": 2, "validators": ids}
    common = dict(
        INVARIANT_CHECKS=[],  # measuring catchup, not the checkers
        TESTING_UPGRADE_MAX_TX_SET_SIZE=2 * per_close,
        TRACE_DIR=os.path.join(work_dir, "traces"),  # slow-close traces
    )
    for i, s in enumerate(seeds):
        kw = dict(common, **HOST)
        if i == 0:
            kw["HISTORY_ARCHIVES"] = [("bench", arch_dir)]
        sim.add_node(s, qset,
                     node_dir=os.path.join(work_dir, f"v{i}"), **kw)
    sim.add_connection(ids[0], ids[1])
    sim.start_all_nodes()
    for _ in range(200):
        if sim.crank() == 0:
            break

    apps = [sim.nodes[i] for i in ids]
    app_a = apps[0]
    signer = LoadGenerator(app_a)
    root = signer.root_key()
    made = [0]

    def inject(n_new):
        """n_new create-account ops from the root account, <= 100 a tx
        (account ids are raw hashes: the ledger does not care, and the
        bench need not pay for curve derivations)."""
        while n_new > 0:
            batch = min(100, n_new)
            ops = []
            for _ in range(batch):
                dest = sha256(b"bench-acct-%d" % made[0])
                ops.append(T.Operation.make(
                    sourceAccount=None, body=T.OperationBody.make(
                        T.OperationType.CREATE_ACCOUNT,
                        T.CreateAccountOp.make(
                            destination=T.account_id(dest),
                            startingBalance=10**7))))
                made[0] += 1
            env = signer._sign_tx(root, ops, 100 * len(ops))
            rc = app_a.herder.recv_transaction(env)
            assert rc == 0, f"tx rejected: {rc}"
            n_new -= batch

    def close_validators(traffic):
        if traffic:
            inject(traffic)
        target = max(a.ledger_manager.last_closed_seq()
                     for a in apps) + 1
        for a in apps:
            a.herder.trigger_next_ledger()
        ok = sim.crank_until(
            lambda: all(a.ledger_manager.last_closed_seq() >= target
                        for a in apps), timeout=300)
        assert ok, f"validators stuck closing {target}"

    # -- phase 1: seed -------------------------------------------------
    n_seed_ledgers = (n_entries + per_close - 1) // per_close
    t0 = time.time()
    remaining = n_entries
    for k in range(n_seed_ledgers):
        close_validators(min(per_close, remaining))
        remaining -= per_close
    seed_s = time.time() - t0
    emit({"phase": "seed", "entries": made[0], "ledgers": n_seed_ledgers,
          "lcl": app_a.ledger_manager.last_closed_seq(),
          "seconds": round(seed_s, 3), "rss_mb": round(rss_mb(), 1)})

    # -- cold join ------------------------------------------------------
    def join_cold(tag, **extra_cfg):
        """Add a cold node to the live net and drive it to synced while
        the validators keep closing (light traffic).  Returns (joiner,
        wall seconds to synced, trailing gap at join, live closes during
        catchup, verify kernel launches)."""
        seed = sha256(b"catchup-bench-joiner-" + tag.encode())
        kw = dict(common)
        kw.update(extra_cfg)
        kw["HISTORY_ARCHIVES"] = [("bench", arch_dir)]
        kw["CRYPTO_BACKEND"] = joiner_backend
        kw["SCP_TALLY_BACKEND"] = \
            "tensor" if joiner_backend == "cuda" else "host"
        trailing = app_a.ledger_manager.last_closed_seq() - 1
        launches0 = ed25519_cuda.launches
        # a joiner is a fresh process: its host verify cache never saw
        # the signatures this process's validators verified
        clear_verify_cache()
        t_start = time.time()
        joiner = sim.add_node(
            seed, {"threshold": 2, "validators": list(ids)},
            node_dir=os.path.join(work_dir, f"joiner-{tag}"), **kw)
        joiner.start()
        jid = joiner.config.node_id()
        for vid in ids:
            sim.add_connection(jid, vid)
        for _ in range(200):
            if sim.crank() == 0:
                break

        def synced():
            return (joiner.ledger_manager.last_closed_seq() >=
                    app_a.ledger_manager.last_closed_seq())

        live = 0
        while not synced():
            close_validators(20)  # the network does not stop for you
            live += 1
            sim.crank_until(synced, timeout=10.0)
            assert live < 4000, (
                f"joiner {tag} stuck: "
                f"{joiner.catchup_manager.status()}")
        dt = time.time() - t_start
        # bit-identity: header chain AND bucket list, every shared seq
        sim.assert_no_forks([ids[0], ids[1], jid])
        assert (joiner.ledger_manager.last_closed_hash() ==
                app_a.ledger_manager.last_closed_hash())
        assert (joiner.bucket_manager.get_bucket_list_hash() ==
                app_a.bucket_manager.get_bucket_list_hash())
        return joiner, dt, trailing, live, ed25519_cuda.launches - launches0

    def phase_split(app):
        out = {}
        for name in ("verify", "apply", "replay"):
            t = app.metrics.timer(f"catchup.phase.{name}")
            out[name + "_s"] = round(t.mean * t.count, 3)
        return out

    def verify_phase(app) -> dict:
        t = app.metrics.timer("ledger.close.phase.verify")
        return {"closes": t.count, "mean_ms": round(t.mean * 1e3, 4)}

    # -- phase 2: minimal ----------------------------------------------
    min_app, min_s, min_trailing, min_live, min_launches = \
        join_cold("minimal")
    applied_bytes = min_app.metrics.counter(
        "catchup.bucket.applied-bytes").count
    applied_entries = min_app.metrics.counter(
        "catchup.bucket.applied-entries").count
    min_phases = phase_split(min_app)
    apply_s = max(min_phases["apply_s"], 1e-9)
    minimal = {
        "trailing_ledgers_at_join": min_trailing,
        "time_to_synced_s": round(min_s, 2),
        "live_closes_during_catchup": min_live,
        "catchup_runs": min_app.catchup_manager.catchup_runs,
        "bucket_applied_bytes": applied_bytes,
        "bucket_applied_entries": applied_entries,
        "bucket_apply_mb_s": round(applied_bytes / 2**20 / apply_s, 2),
        "chain_headers_verified": min_app.metrics.counter(
            "catchup.chain.verified").count,
        "phase_split": min_phases,
        "verify_phase": verify_phase(min_app),
        "kernel_launches": min_launches,
        "bit_identical": True,
    }
    emit({"phase": "minimal", **minimal})

    # -- phase 3: complete ----------------------------------------------
    cmp_app, cmp_s, cmp_trailing, cmp_live, cmp_launches = join_cold(
        "complete", CATCHUP_COMPLETE=True)
    replayed = cmp_app.metrics.counter("catchup.ledger.replayed").count
    cmp_phases = phase_split(cmp_app)
    replay_s = max(cmp_phases["replay_s"], 1e-9)
    complete = {
        "trailing_ledgers_at_join": cmp_trailing,
        "time_to_synced_s": round(cmp_s, 2),
        "live_closes_during_catchup": cmp_live,
        "catchup_runs": cmp_app.catchup_manager.catchup_runs,
        "ledgers_replayed": replayed,
        "replay_ledgers_per_s": round(replayed / replay_s, 2),
        "phase_split": cmp_phases,
        "verify_phase": verify_phase(cmp_app),
        "kernel_launches": cmp_launches,
        "bit_identical": True,
    }
    emit({"phase": "complete", **complete})

    speedup = cmp_s / max(min_s, 1e-9)
    return {
        "tier": "smoke" if smoke else
                "1M" if n_entries == FULL_TIER_ENTRIES else "custom",
        "joiner_backend": joiner_backend,
        "device": str(device),
        "n_entries": made[0],
        "seed_ledgers": n_seed_ledgers,
        "entries_per_close": per_close,
        "seed_seconds": round(seed_s, 1),
        "seed_entries_per_s": round(made[0] / seed_s, 1),
        "final_lcl": app_a.ledger_manager.last_closed_seq(),
        "minimal": minimal,
        "complete": complete,
        "minimal_speedup_vs_complete": round(speedup, 2),
        "rss_mb": round(rss_mb(), 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--smoke", action="store_true",
                    help="small tier: quick correctness pass")
    ap.add_argument("--entries", type=int, default=None)
    ap.add_argument("--per-close", type=int, default=None)
    ap.add_argument("--joiner-backend", choices=["cuda", "cpu"],
                    default=None,
                    help="the joiners' CRYPTO_BACKEND (default cuda on "
                         "the GPU, cpu with --device cpu)")
    ap.add_argument("--out", default=None,
                    help="also write the result to this file")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.device == "cpu" and args.joiner_backend == "cuda":
        ap.error("--device cpu runs the host tiers: the joiners' backend "
                 "is cpu")
    joiner_backend = args.joiner_backend or \
        ("cpu" if args.device == "cpu" else "cuda")
    if args.device is None and no_gpu(PROG):
        return 2

    if args.smoke:
        n_entries = args.entries or 12_000
        per_close = args.per_close or 400
    else:
        n_entries = args.entries or FULL_TIER_ENTRIES
        per_close = args.per_close or 1_000
    assert per_close % 100 == 0, "per_close must be a multiple of 100"

    with tempfile.TemporaryDirectory(prefix="catchup-bench-") as work_dir:
        result = run(n_entries, per_close, joiner_backend,
                     node_kw(args.device)["device"], work_dir, args.smoke)
    result["gates_checked"] = not args.smoke
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    emit(result)
    if not args.smoke:
        assert result["minimal"]["trailing_ledgers_at_join"] >= 1000, \
            "the joiner trailed fewer than 1,000 ledgers"
        assert result["minimal_speedup_vs_complete"] >= 5.0, \
            "minimal catchup less than 5x faster than complete"
    return 0


if __name__ == "__main__":
    sys.exit(main())
