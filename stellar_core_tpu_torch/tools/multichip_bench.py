"""Bench-shaped data-parallel admission on the port, the counterpart of the
repository's ``tools/multichip_bench.py``: the sharded verify of a
100,000-signature batch and a 64-validator ballot tally with the validator axis
split (``models/admission.bench_sharded``), beside the one-device run at
the SAME batch (per-device rates are comparable only at equal batches).

On the GPU the ``cuda`` arm splits over every visible card and the
``cpu`` arm over ``--cpu-chunks`` CPU chunks of one host (more than one
device exists on a one-card host only as CPU chunks); each row says which
devices it ran on.  The CPU arm runs the plain torch verify, so its batch
is ``--cpu-sigs``.  Signatures are made here from a seed (the repository's
tool reads a capture file that the repository does not hold).

Prints one JSON line an arm and the result last; writes the result to a
file only with ``--out``.

Usage: python -m stellar_core_tpu_torch.tools.multichip_bench
           [--cpu-sigs N] [--cpu-chunks N]
           [--backend cuda|cpu] [--out PATH] [--device cpu]
"""
import argparse
import sys

from . import add_backend_arg, arm, backends, emit, no_gpu, write_out

PROG = "python -m stellar_core_tpu_torch.tools.multichip_bench"
CUDA_SIGS = 100_000     # the cuda arm's batch (the repository tool's)


def run_arm(backend: str, n_sigs: int, cpu_chunks: int) -> dict:
    """``bench_sharded`` over the arm's devices and over its first device
    alone, at ``n_sigs``."""
    import torch

    from ..models.admission import bench_sharded

    if backend == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")] * cpu_chunks
    with arm(backend) as row:
        row["sharded"] = bench_sharded(n_sigs=n_sigs, devices=devices)
        row["one_device_comparison"] = bench_sharded(
            n_sigs=n_sigs, devices=devices[:1])
        row["ran_on"] = [str(d) for d in devices]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG,
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-sigs", type=int, default=512,
                    help="signatures of the cpu arm (default 512)")
    ap.add_argument("--cpu-chunks", type=int, default=8)
    ap.add_argument("--out", default=None)
    add_backend_arg(ap)
    args = ap.parse_args(argv)
    arms = backends(ap, args)
    if args.device is None and no_gpu(PROG):
        return 2
    rows = []
    for backend in arms:
        n = CUDA_SIGS if backend == "cuda" else args.cpu_sigs
        rows.append(run_arm(backend, n, args.cpu_chunks))
        emit(rows[-1])
    doc = {"bench": "data-parallel admission", "arms": rows,
           "note": ("the cpu arm's chunks share one host's cores: its "
                    "per-device rate is a program-shape number, not "
                    "scaling; each arm's one-device run verifies the same "
                    "batch as its sharded run")}
    write_out(args.out, doc)
    emit(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
