"""The live SCP federated tally through the hand-written CUDA kernel
``csrc/quorum_tally.cu``: one call of ``TallyEngine.device_accept`` or
``device_ratify`` on a CUDA device is one copy of the vote rows in, one
launch, one copy of the verdict out and one synchronisation.

The kernel replaces no Pallas kernel: it replaces the chain of torch ops
(``ops/quorum.py``) that the tally engine runs on a CPU device, which stays
the plain version.  Here CUDA tensors launch the kernel or raise: there is
no fallback to the torch ops.

The rows go through pinned host buffers and device buffers that each
thread reuses on each device; a call synchronises its stream before it
returns, so the next call may overwrite them.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build
from .quorum import QSetTensor

KERNEL = "quorum_tally"
SOURCE = "quorum_tally.cu"

# Launches of the kernel in this process: incremented where the kernel is
# launched and nowhere else.  Callers count a path by the difference.
launches = 0


@functools.cache
def build() -> _build.Built:
    """Build and load the kernel library, once per process."""
    built = _build.build(KERNEL, SOURCE, {})
    fn = built.lib.quorum_tally_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return built


class _Buffers:
    """One thread's pinned and device buffers on one device: the vote rows
    (at least ``size`` bytes) and the verdict byte."""

    def __init__(self, device: torch.device, size: int):
        self.size = size
        self.h_rows = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        self.h_rows_np = self.h_rows.numpy()
        self.d_rows = torch.empty(size, dtype=torch.uint8, device=device)
        self.h_out = torch.empty(1, dtype=torch.uint8, pin_memory=True)
        self.h_out_np = self.h_out.numpy()
        self.d_out = torch.empty(1, dtype=torch.uint8, device=device)
        self.ptrs = (self.h_rows.data_ptr(), self.d_rows.data_ptr())
        self.out_ptrs = (self.d_out.data_ptr(), self.h_out.data_ptr())


_local = threading.local()


def _buffers(device: torch.device, size: int) -> _Buffers:
    per_device = getattr(_local, "buffers", None)
    if per_device is None:
        per_device = _local.buffers = {}
    buf = per_device.get(device)
    if buf is None or buf.size < size:
        buf = per_device[device] = _Buffers(device, max(size, 1024))
    return buf


def _checked(local_qs: QSetTensor, qsets: QSetTensor, rows: np.ndarray,
             n_rows: int) -> tuple[int, int, int]:
    """(N, K, KL) of a tally the kernel takes; raises ValueError on
    anything else."""
    if not isinstance(rows, np.ndarray) or rows.dtype != np.bool_ or \
            rows.ndim != 2 or rows.shape[0] != n_rows:
        raise ValueError(f"rows must be a numpy bool array ({n_rows}, N), "
                         f"got {type(rows).__name__} "
                         f"{getattr(rows, 'dtype', None)} "
                         f"{getattr(rows, 'shape', None)}")
    n = rows.shape[1]
    k = qsets.inner_thr.shape[-1] if qsets.inner_thr.dim() == 2 else -1
    kl = local_qs.inner_thr.shape[-1] if local_qs.inner_thr.dim() == 1 else -1
    dev = qsets.top_mem.device
    if dev.type != "cuda":
        raise ValueError(f"the tally kernel takes CUDA tensors, got {dev}")
    want = (("qsets.top_mem", qsets.top_mem, torch.bool, (n, n)),
            ("qsets.top_thr", qsets.top_thr, torch.int32, (n,)),
            ("qsets.inner_mem", qsets.inner_mem, torch.bool, (n, k, n)),
            ("qsets.inner_thr", qsets.inner_thr, torch.int32, (n, k)),
            ("local_qs.top_mem", local_qs.top_mem, torch.bool, (n,)),
            ("local_qs.top_thr", local_qs.top_thr, torch.int32, ()),
            ("local_qs.inner_mem", local_qs.inner_mem, torch.bool, (kl, n)),
            ("local_qs.inner_thr", local_qs.inner_thr, torch.int32, (kl,)))
    for label, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{label} must be a contiguous {dtype} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n == 0:
        raise ValueError("a tally needs at least one node")
    return n, k, kl


def _tally(local_qs: QSetTensor, qsets: QSetTensor, rows: np.ndarray,
           n_rows: int) -> bool:
    global launches
    n, k, kl = _checked(local_qs, qsets, rows, n_rows)
    dev = qsets.top_mem.device
    fn = build().lib.quorum_tally_launch
    with torch.cuda.device(dev):
        buf = _buffers(dev, rows.size)
        buf.h_rows_np[:rows.size] = rows.reshape(-1)
        stream = torch.cuda.current_stream(dev)
        rc = fn(*(t.data_ptr() for t in qsets),
                *(t.data_ptr() for t in local_qs), n, k, kl, *buf.ptrs,
                n_rows, *buf.out_ptrs, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quorum_tally launch failed: cudaError {rc}")
        launches += 1
        stream.synchronize()
    return bool(buf.h_out_np[0])


def tally_accept(local_qs: QSetTensor, qsets: QSetTensor,
                 rows: np.ndarray) -> bool:
    """Federated accept of one statement: host rows (2, N) bool —
    accepted, voted-or-accepted — against the local qset ``local_qs`` and
    every node's ``qsets`` (CUDA QSetTensors of ``ops/quorum.py``, K inner
    sets a node's qset, KL the local one's): the accepted row v-blocking,
    or a quorum inside the second row that satisfies the local slice."""
    return _tally(local_qs, qsets, rows, 2)


def tally_ratify(local_qs: QSetTensor, qsets: QSetTensor,
                 rows: np.ndarray) -> bool:
    """Federated ratify of one statement: host row (1, N) bool — voted —
    holds a quorum that satisfies the local slice (as ``tally_accept``)."""
    return _tally(local_qs, qsets, rows, 1)
