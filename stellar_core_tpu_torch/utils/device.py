"""Default-device resolution, the CPU thread policy, and the signature
batch's packing and fixed sizes.

The port's entry points run on the GPU unless the caller names a device;
with no GPU and no explicit device they raise instead of carrying on
quietly on the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_CPU_THREADS_LOCK = threading.RLock()


@contextlib.contextmanager
def cpu_threads(device):
    """The one policy for the port's CPU tensor routes (the plain verify
    behind the kernel's wrapper, the SCP tallies, quorum contractions and
    the admission step on a CPU device): while one runs, torch's intra-op
    pool has one thread, and the caller's count comes back after.  On any
    other device this does nothing.

    That work is tens of thousands of small ops, which gain nothing from
    the pool; a pool forks and joins its threads on every op it
    parallelises, and when other processes hold the cores (parallel test
    workers with pools of their own) every join waits for a thread that is
    not running.  One 256-row plain verify took 3.9 s alone on 8 threads
    and did not finish in 600 s with 6 such processes at once on 8 CPU
    cores.  The thread count is the process's, so routes run one at a
    time under a re-entrant lock (a route may enter another)."""
    if torch.device(device).type != "cpu":
        yield
        return
    with _CPU_THREADS_LOCK:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device, or ``cuda`` when none is given.
    Raises RuntimeError when no device is given and no GPU is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch version on the CPU")
    return torch.device("cuda")


# Fixed signature-batch sizes: every device verify pads its batch up to
# one of these, so admission traffic cannot present a new shape per close.
# Beyond the largest bucket, batches round up to its multiple.
SIG_BATCH_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                     65536, 131072)


def pad_signature_batch(n: int) -> int:
    """Smallest allowed batch size >= n."""
    if n <= 0:
        return SIG_BATCH_BUCKETS[0]
    for b in SIG_BATCH_BUCKETS:
        if n <= b:
            return b
    top = SIG_BATCH_BUCKETS[-1]
    return ((n + top - 1) // top) * top


def signature_columns(triples) -> tuple:
    """[(pubkey, sig, msg)] bytes -> (pk (n,32), sg (n,64), mg (n,32))
    uint8, signatures zero-padded to 64 bytes as the close pads them."""
    n = len(triples)
    return tuple(
        np.frombuffer(b"".join(t[i].ljust(w, b"\x00") for t in triples),
                      np.uint8).reshape(n, w)
        for i, w in enumerate((32, 64, 32)))


def padded_signature_batch(pk, sg, mg) -> tuple:
    """The columns with their rows repeated up to the
    ``pad_signature_batch`` size, so the device sees a small closed set
    of shapes."""
    idx = np.arange(pad_signature_batch(pk.shape[0])) % pk.shape[0]
    return tuple(np.ascontiguousarray(a[idx]) for a in (pk, sg, mg))
