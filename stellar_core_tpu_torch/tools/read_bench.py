"""BucketListDB read-path bench on the port, the counterpart of the
repository's ``tools/read_bench.py``: an ``N``-entry (default 1,000,000)
disk-tier BucketList serves point reads through the per-bucket
bloom-filtered indexes, and the result shows

- the bucket probes per point read against the linear-scan baseline (the
  same list with ``index_enabled=False``), >= 10x fewer at 500,000
  entries and more;
- zero SQL queries on a live node's point-lookup path (``LedgerTxnRoot``
  in BucketListDB mode), on a ``cuda`` node and a ``cpu`` node of the
  same host, with the reads each tier served;
- a bucket-list hash bit-identical between an indexed and an unindexed
  build of the same workload;
- the index build cost per close against close p50.

The list is the host's alone (no device tier); bucket files live in a
temporary directory.  Prints one line a measurement and the result last;
writes the result to a file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.read_bench
           [N_ENTRIES [PER_CLOSE [N_READS]]] [--backend cuda|cpu]
           [--out PATH] [--device cpu]
"""
import argparse
import resource
import shutil
import statistics
import sys
import tempfile
import time

from . import (add_backend_arg, arm, backends, card, emit, no_gpu,
               standalone_app, write_out)
from .bucket_scale_bench import build_list

PROG = "python -m stellar_core_tpu_torch.tools.read_bench"


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def sample_keys(n_entries, n_reads):
    from ..ledger.ledger_txn import entry_to_key, key_bytes
    from ..transactions import utils as U

    present = []
    step = max(1, n_entries // (n_reads * 4 // 5))
    for i in range(0, n_entries, step):
        present.append(key_bytes(entry_to_key(U.make_account_entry(
            i.to_bytes(4, "big") * 8, 1))))
        if len(present) >= n_reads * 4 // 5:
            break
    absent = [key_bytes(entry_to_key(U.make_account_entry(
        (0x7F000000 + i).to_bytes(4, "big") * 8, 1)))
        for i in range(n_reads - len(present))]
    return present, absent


def measure_reads(bl, present, absent, label):
    base = dict(bl.stats)
    lat = []
    for kb in present:
        t0 = time.perf_counter()
        e = bl.get_entry(kb)
        lat.append(time.perf_counter() - t0)
        assert e is not None, kb.hex()
    for kb in absent:
        t0 = time.perf_counter()
        e = bl.get_entry(kb)
        lat.append(time.perf_counter() - t0)
        assert e is None
    reads = bl.stats["point_reads"] - base["point_reads"]
    probes = bl.stats["bucket_probes"] - base["bucket_probes"]
    checks = bl.stats["bloom_checks"] - base["bloom_checks"]
    fps = bl.stats["bloom_false_positives"] - base["bloom_false_positives"]
    lat.sort()
    out = {
        "measurement": label,
        "reads": reads,
        "probes": probes,
        "probes_per_read": round(probes / reads, 4),
        "bloom_false_positive_rate": round(fps / checks, 6) if checks
        else 0.0,
        "read_us_p50": round(lat[len(lat) // 2] * 1e6, 1),
        "read_us_p99": round(lat[int(len(lat) * 0.99)] * 1e6, 1),
    }
    emit(out)
    return out


def sql_free_node_check(backend: str) -> dict:
    """A live ``backend`` node in BucketListDB mode: point lookups +
    prefetch issue ZERO SQL queries (the Database wrapper's query
    counter); the reads each tier served."""
    from ..ledger.ledger_txn import entry_to_key, key_bytes
    from ..main.http_server import CommandHandler
    from ..simulation.load_generator import LoadGenerator
    from ..transactions import utils as U

    with arm(backend) as row:
        app = standalone_app(backend)
        handler = CommandHandler(app)
        # one 100-op batch tx per close: the default tx-set cap is 100 ops
        code, body = handler.handle("generateload",
                                    {"mode": "create", "accounts": "100"})
        assert code == 200 and body["status_counts"] == {0: 1}, body
        app.herder.manual_close()
        code, body = handler.handle("generateload",
                                    {"mode": "pay", "txs": "100"})
        assert code == 200 and body["status_counts"] == {0: 100}, body
        app.herder.manual_close()
        root = app.ledger_manager.root
        assert root.bucket_reads_enabled
        kbs = [key_bytes(entry_to_key(U.make_account_entry(
            LoadGenerator.account_key(i).public_key().raw, 0)))
            for i in range(100)]
        root._entry_cache.clear()
        q0 = app.database.queries
        for kb in kbs:
            assert root.get(kb) is not None
        root._entry_cache.clear()
        root.prefetch(kbs)
        row["sql_queries_point_lookup"] = app.database.queries - q0
        row["point_reads_served_by"] = {
            "bucket": root.reads_from_buckets,
            "overlay": root.reads_from_overlay,
            "sql": root.reads_from_sql}
        app.graceful_stop()
    return row


def run(n_entries: int, per_close: int, n_reads: int, arms) -> dict:
    tmp = tempfile.mkdtemp(prefix="read-bench-")
    try:
        t0 = time.time()
        bl, close_times, _ = build_list(n_entries, per_close, tmp, True,
                                        progress=emit)
        build_s = time.time() - t0
        present, absent = sample_keys(n_entries, n_reads)
        indexed = measure_reads(bl, present, absent, "indexed")
        indexed_hash = bl.hash().hex()
        index_build_s = bl.stats["index_build_s"]
        index_mem = bl.index_memory_bytes()
        n_buckets = sum(1 for _ in bl._buckets_shallow_first())
        # linear-scan baseline on the SAME list (fewer reads: each one
        # scans every bucket)
        bl.index_enabled = False
        lin_reads = max(200, n_reads // 20)
        linear = measure_reads(bl, present[:lin_reads * 4 // 5],
                               absent[:lin_reads // 5], "linear")
        del bl
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tmp2 = tempfile.mkdtemp(prefix="read-bench-noidx-")
    try:
        bl2, close_times_noidx, _ = build_list(n_entries, per_close, tmp2,
                                               False, progress=emit)
        unindexed_hash = bl2.hash().hex()
        del bl2
    finally:
        shutil.rmtree(tmp2, ignore_errors=True)

    nodes = [sql_free_node_check(b) for b in arms]
    for row in nodes:
        emit({"measurement": "sql_free_node", **row})
    closes = len(close_times)
    return {
        "n_entries": n_entries,
        "per_close": per_close,
        "closes": closes,
        "build_seconds": round(build_s, 1),
        "close_ms_p50": round(statistics.median(close_times) * 1000, 1),
        "close_ms_max": round(max(close_times) * 1000, 1),
        "close_ms_p50_noindex": round(
            statistics.median(close_times_noidx) * 1000, 1),
        "index_build_ms_per_close": round(index_build_s * 1000 / closes, 3),
        "index_memory_bytes": index_mem,
        "live_buckets": n_buckets,
        "point_reads": indexed["reads"],
        "read_us_p50": indexed["read_us_p50"],
        "read_us_p99": indexed["read_us_p99"],
        "probes_per_read": indexed["probes_per_read"],
        "bloom_false_positive_rate": indexed["bloom_false_positive_rate"],
        "linear_probes_per_read": linear["probes_per_read"],
        "linear_read_us_p50": linear["read_us_p50"],
        "probe_reduction_x": round(
            linear["probes_per_read"] / indexed["probes_per_read"], 1),
        "nodes": nodes,
        "sql_queries_point_lookup": max(
            n["sql_queries_point_lookup"] for n in nodes),
        "bucket_hash_indexed": indexed_hash,
        "bucket_hash_unindexed": unindexed_hash,
        "hash_bit_identical": indexed_hash == unindexed_hash,
        "rss_mb_peak": round(rss_mb(), 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n_entries", nargs="?", type=int, default=1_000_000)
    ap.add_argument("per_close", nargs="?", type=int, default=10_000)
    ap.add_argument("n_reads", nargs="?", type=int, default=20_000)
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    out = run(args.n_entries, args.per_close, args.n_reads, arms)
    out["card"] = card()
    write_out(args.out, out)
    emit(out)
    assert out["hash_bit_identical"], "index changed the bucket hash!"
    assert out["sql_queries_point_lookup"] == 0, "SQL on the point path"
    # the >=10x probe-reduction bar applies at the 1M-entry scale; small
    # runs have too few buckets to scan
    if args.n_entries >= 500_000:
        assert out["probe_reduction_x"] >= 10, "probe reduction below 10x"
    return 0


if __name__ == "__main__":
    sys.exit(main())
