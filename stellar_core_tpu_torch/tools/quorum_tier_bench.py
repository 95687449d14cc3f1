"""Quorum-intersection tier shoot-out on the port, the counterpart of the
repository's ``tools/quorum_tier_bench.py``: the native C++ enumerator,
the Python enumerator with the numpy contractor and the Python enumerator
with the device contractor, at growing SCC sizes.

Topologies are flat majority cliques with a per-node twist (every node's
qset drops a different neighbour), so the org-collapse reduction cannot
fire and the enumerator genuinely runs.  The device tier runs once a
backend: on the card (``device="cuda"``; ``ContractorProbe`` times every
contractor chunk by CUDA events and holds its rows to a host fixpoint)
and on the CPU (``device="cpu"``, plain torch) on the same host.  A tier
stops at ``--max-seconds`` (a wall-clock budget, as the repository's
tool), an aborted scan giving ``ok`` None.

Prints one JSON line a size and the result last; writes the result to a
file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.quorum_tier_bench
           [SIZES ...] [--max-seconds S]
           [--backend cuda|cpu] [--out PATH] [--device cpu]
"""
import argparse
import sys
import time

from . import add_backend_arg, backends, card, emit, no_gpu, write_out

PROG = "python -m stellar_core_tpu_torch.tools.quorum_tier_bench"
HOST_TIERS = (("native", {"use_native": True, "use_device": False}),
              ("python_numpy", {"use_native": False, "use_device": False}))


def build_qmap(n):
    from ..scp.local_node import make_qset

    nodes = [b"%02d" % i + b"\x00" * 30 for i in range(n)]
    thr = 2 * n // 3 + 1
    qmap = {}
    for i, x in enumerate(nodes):
        members = [v for j, v in enumerate(nodes) if j != (i + 1) % n]
        qmap[x] = make_qset(min(thr, len(members)), members, [])
    return qmap


def _scan(qmap, max_seconds, **kw) -> dict:
    from ..herder.quorum_intersection import check_quorum_intersection

    t0 = time.perf_counter()
    res = check_quorum_intersection(qmap, max_seconds=max_seconds, **kw)
    dt = time.perf_counter() - t0
    assert res.ok is True or res.aborted, (kw, res.ok)
    return {"seconds": round(dt, 3), "ok": res.ok, "scanned": res.scanned,
            "aborted": bool(res.aborted), "tier": res.tier,
            "subproblems_per_s": round(res.scanned / dt, 1) if dt else None}


def tier_row(n: int, arms, max_seconds=120.0) -> dict:
    """The three tiers at ``n`` nodes; the device tier once for each of
    ``arms`` (``cuda``, ``cpu``), under ``row["python_device"][arm]``."""
    import torch

    from ..herder import quorum_intersection as QI
    from ..ops import quorum as Q
    from .contractor_probe import ContractorProbe

    qmap = build_qmap(n)
    row = {"scc_size": n}
    for label, kw in HOST_TIERS:
        row[label] = _scan(qmap, max_seconds, **kw)
    row["python_device"] = {}
    for backend in arms:
        kw = {"use_native": False, "use_device": True, "device": backend}
        if backend == "cuda":
            with ContractorProbe(QI, Q) as probe:
                cell = _scan(qmap, max_seconds, **kw)
            torch.cuda.synchronize()
            stats = probe.stats()
            if stats["mismatched_rows"]:
                raise AssertionError(f"device tier != host fixpoint at {n} "
                                     f"nodes: {stats}")
            cell["contractor"] = {k: stats[k] for k in (
                "chunks", "rows", "chunk_rows_max", "ms_per_chunk",
                "ms_per_chunk_max", "trips_per_chunk", "bound_ms_per_chunk",
                "share_of_bound", "device_ms", "mismatched_rows",
                "check_seconds")}
            cell["card"] = card()
        else:
            cell = _scan(qmap, max_seconds, **kw)
        cell["device"] = backend
        row["python_device"][backend] = cell
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    default=[16, 24, 32, 48])
    ap.add_argument("--max-seconds", type=float, default=120.0,
                    help="wall-clock budget of each tier (default 120)")
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    from .. import native

    native.get_lib()   # g++, outside the native tier's timed scans
    rows = []
    for n in args.sizes:
        row = tier_row(n, arms, args.max_seconds)
        rows.append(row)
        emit(row)
    doc = {"bench": "quorum tier shoot-out", "card": card(),
           "max_seconds": args.max_seconds,
           "backends": arms, "rows": rows}
    write_out(args.out, doc)
    emit(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
