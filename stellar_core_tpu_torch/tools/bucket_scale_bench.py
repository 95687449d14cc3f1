"""Bucket scale bench on the port, the counterpart of the repository's
``tools/bucket_scale_bench.py``: a synthetic ``N``-entry ledger (default
1,000,000) flows through the port's disk-tier BucketList and back out of
a catchup-style streaming read, in the real close configuration:
background merges on a worker pool with the native streaming merge
kernel (``build/torch_native/``), every bucket indexed at creation/merge
time.  The index-off build runs first in the same session, so
``index_overhead_pct`` is a same-run A/B, and the two builds' bucket-list
hashes must be equal.

This path is the host's alone (no node, no device tier): on the GPU's
host the result carries the card's name and power limit to say which
machine ran it.  Bucket files live in a temporary directory.  Prints a
progress line every 50 closes and the result last; writes the result to a
file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.bucket_scale_bench
           [N_ENTRIES [PER_CLOSE]] [--out PATH] [--device cpu]
"""
import argparse
import os
import resource
import shutil
import statistics
import sys
import tempfile
import time

from . import add_device_arg, card, emit, no_gpu, write_out

PROG = "python -m stellar_core_tpu_torch.tools.bucket_scale_bench"


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def account_change(i: int, balance: int):
    """The ``i``-th synthetic account entry as a BucketList change."""
    from ..ledger.ledger_txn import entry_to_key, key_bytes
    from ..transactions import utils as U

    e = U.make_account_entry(i.to_bytes(4, "big") * 8, balance)
    return key_bytes(entry_to_key(e)), e, False


def build_list(n_entries: int, per_close: int, tmp: str, indexed: bool,
               progress=None):
    """A BucketList over ``tmp`` (disk tier from level 2, two merge
    workers) fed ``n_entries`` accounts, ``per_close`` a close; returns
    (list, per-close add_batch seconds, last seq).  The workers are shut
    down before the return."""
    from concurrent.futures import ThreadPoolExecutor

    from ..bucket.bucket_list import BucketList

    executor = ThreadPoolExecutor(max_workers=2,
                                  thread_name_prefix="bucket-merge")
    bl = BucketList(executor=executor, disk_dir=tmp, disk_level=2)
    bl.index_enabled = indexed
    close_times = []
    seq = 1
    made = 0
    while made < n_entries:
        seq += 1
        changes = [account_change(made + j, 10_000_000 + made + j)
                   for j in range(min(per_close, n_entries - made))]
        made += len(changes)
        t0 = time.perf_counter()
        bl.add_batch(seq, changes)
        close_times.append(time.perf_counter() - t0)
        if progress is not None and seq % 50 == 0:
            progress({"seq": seq, "indexed": indexed, "entries": made,
                      "rss_mb": round(rss_mb(), 1)})
    executor.shutdown(wait=True)
    return bl, close_times, seq


def run(n_entries: int, per_close: int, progress=None) -> dict:
    from ..bucket.disk_bucket import DiskBucket

    rss_start = rss_mb()
    # index-off baseline FIRST (same session, same machine state)
    tmp0 = tempfile.mkdtemp(prefix="bucket-scale-noidx-")
    try:
        t0 = time.time()
        bl0, close_times_noidx, _ = build_list(n_entries, per_close, tmp0,
                                               False, progress)
        build_s_noidx = time.time() - t0
        hash_noidx = bl0.hash().hex()
        del bl0
    finally:
        shutil.rmtree(tmp0, ignore_errors=True)

    tmp = tempfile.mkdtemp(prefix="bucket-scale-")
    try:
        t0 = time.time()
        bl, close_times, seq = build_list(n_entries, per_close, tmp, True,
                                          progress)
        build_s = time.time() - t0
        rss_after_build = rss_mb()

        # catchup-style streaming read of the full live set
        t0 = time.time()
        count = sum(1 for _ in bl.iter_live_entries())
        stream_s = time.time() - t0
        assert count == n_entries, (count, n_entries)

        disk_files = [f for f in os.listdir(tmp)
                      if f.startswith("bucket-") and f.endswith(".xdr")]
        disk_bytes = sum(
            os.path.getsize(os.path.join(tmp, f)) for f in disk_files)
        disk_levels = sum(
            1 for lv in bl.levels for b in (lv.curr, lv.snap)
            if isinstance(b, DiskBucket) and not b.is_empty())
        out = {
            "n_entries": n_entries,
            "per_close": per_close,
            "closes": seq - 1,
            "build_seconds": round(build_s, 1),
            "build_seconds_noindex": round(build_s_noidx, 1),
            "close_ms_p50": round(statistics.median(close_times) * 1000, 1),
            "close_ms_max": round(max(close_times) * 1000, 1),
            "close_ms_p50_noindex": round(
                statistics.median(close_times_noidx) * 1000, 1),
            "close_ms_max_noindex": round(
                max(close_times_noidx) * 1000, 1),
            "index_overhead_pct": round(
                (statistics.median(close_times)
                 / statistics.median(close_times_noidx) - 1) * 100, 1),
            "stream_read_seconds": round(stream_s, 1),
            "streamed_entries": count,
            "rss_mb_start": round(rss_start, 1),
            "rss_mb_after_build": round(rss_after_build, 1),
            "rss_mb_after_stream": round(rss_mb(), 1),
            "disk_bucket_files": len(disk_files),
            "disk_bucket_bytes": disk_bytes,
            "disk_backed_buckets_live": disk_levels,
            "bucket_hash": bl.hash().hex(),
            "bucket_hash_noindex": hash_noidx,
            "merge_pipeline": {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in bl.stats.items()},
            "background_merges": True,
            "index_build_ms_per_close": round(
                bl.stats["index_build_s"] * 1000 / (seq - 1), 3),
            "index_memory_bytes": bl.index_memory_bytes(),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert out["bucket_hash"] == out["bucket_hash_noindex"], \
        "the index changed the bucket hash"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n_entries", nargs="?", type=int, default=1_000_000)
    ap.add_argument("per_close", nargs="?", type=int, default=10_000)
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.device is None and no_gpu(PROG):
        return 2
    out = run(args.n_entries, args.per_close, progress=emit)
    out["card"] = card()
    out["path"] = "host (bucket/, native merge): no device tier"
    write_out(args.out, out)
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
