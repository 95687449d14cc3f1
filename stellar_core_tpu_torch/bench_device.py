"""Verify stage of the port's headline bench: the counterpart of the
repository's root ``bench_device.py``.

    python -m stellar_core_tpu_torch.bench_device <workload.npz> [--device cpu]

The workload holds ``pk`` (N, 32), ``sg`` (N, 64) and ``mg`` (N, 32)
uint8.  The batch is padded to ``pad_signature_batch(N)`` rows by repeating
real rows, as the node pads, and verified by ``ops/ed25519_cuda.
verify_batch`` on the card: the kernel is built and launched, or this
raises (there is no fallback to another verify).  ``--device cpu`` runs the
wrapper's plain torch version instead; it is the only CPU route, for tests.

Prints one JSON line: ``kernel``, ``rate`` (real signatures per second of
the median host-clock time from numpy in to numpy verdicts out, over
``REPS`` runs after a first call that builds the kernel), ``n``,
``n_padded``, ``build_s`` (the first call, build included), ``device``, and
on the card ``kernel_ms`` (the median kernel-only time by CUDA events).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .ops import ed25519_cuda
from .utils.device import default_device, padded_signature_batch

REPS = 3   # timed runs of the stage, and of the kernel alone


def run(pk, sg, mg, device=None) -> dict:
    """Time the verify stage on ``device`` (default: the GPU, raising when
    there is none).  Returns the line's fields plus ``verdicts``, the
    padded batch's (numpy bool), and ``padded``, the padded numpy batch."""
    dev = default_device(device)
    n_real = pk.shape[0]
    padded = padded_signature_batch(pk, sg, mg)
    on_card = dev.type == "cuda"

    def verify() -> np.ndarray:
        ins = [torch.as_tensor(x, device=dev) for x in padded]
        return ed25519_cuda.verify_batch(*ins).cpu().numpy()

    t0 = time.perf_counter()
    ok = verify()
    build_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        ok = verify()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    out = {"kernel": "cuda" if on_card else "plain",
           "rate": n_real / dt, "n": n_real, "n_padded": padded[0].shape[0],
           "build_s": build_s, "stage_s": times,
           "device": (torch.cuda.get_device_name(dev) if on_card
                      else dev.type),
           "kernel_ms": None}
    if on_card:
        ins = [torch.as_tensor(x, device=dev) for x in padded]
        ms = []
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            ed25519_cuda.verify_batch(*ins)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out["kernel_ms"] = statistics.median(ms)
    out.update(verdicts=ok, padded=padded)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stellar_core_tpu_torch.bench_device")
    ap.add_argument("workload", help=".npz with pk, sg, mg")
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="run the plain torch version on the CPU "
                         "(default: the kernel on the GPU)")
    args = ap.parse_args(argv)
    data = np.load(args.workload)
    res = run(data["pk"], data["sg"], data["mg"], device=args.device)
    ok = res.pop("verdicts")
    res.pop("padded")
    if not ok.all():
        raise AssertionError(f"{int((~ok).sum())} signatures rejected")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
