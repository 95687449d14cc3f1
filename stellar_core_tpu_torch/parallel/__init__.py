"""Data-parallel layout for the device tier: the port's counterpart of the
JAX package's mesh layer (``parallel/__init__.py``: ``data_parallel_mesh``,
``dp``, ``replicated``).

torch has no sharded tensor here, so the layout is explicit: a list of
devices along the ``data`` axis, a tensor split into one contiguous chunk
per device (``dp``), or one copy per device (``replicated``).  The
admission pipeline splits signature batches and the validator axis of the
ballot tallies, and replicates the small quorum tensors and statement
matrices (the layout SURVEY.md §2.17 P5/P6 prescribes).
"""
from __future__ import annotations

from typing import List, Optional

import torch

DATA_AXIS = "data"


def data_parallel_devices(n_devices: Optional[int] = None,
                          devices=None) -> List[torch.device]:
    """The first ``n_devices`` (default: all) of ``devices`` (default: the
    visible CUDA devices) along ``DATA_AXIS``.  Raises ValueError when
    asked for more devices than there are, and when there are none."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("no devices: no CUDA device is visible and none "
                         "was given")
    return devs


def dp(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """The leading axis of ``x`` split into ``len(devices)`` contiguous
    chunks (``torch.tensor_split``: sizes differ by at most one), chunk i
    on ``devices[i]``."""
    return [c.to(d).contiguous()
            for c, d in zip(torch.tensor_split(x, len(devices)), devices)]


def replicated(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """One copy of ``x`` on each of ``devices``."""
    return [x.to(d) for d in devices]
