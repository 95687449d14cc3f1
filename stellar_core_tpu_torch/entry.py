"""Entry points of the port: the counterpart of the repository's root
``__graft_entry__.py``, which stays the JAX package's.

- ``entry()`` — the admission step (batched ed25519 verify through the
  CUDA kernel + the quorum tally) and an example batch on the card;
- ``dryrun_multichip(n)`` — the data-parallel admission step over ``n``
  CPU chunks, held against the unsharded step.
"""
from __future__ import annotations


def entry(device=None):
    """``(admission_step, example_batch(n_sigs=8, n_nodes=4))`` with the
    batch on ``device`` (default: the GPU; raises when there is none)."""
    from .models.admission import admission_step, example_batch

    return admission_step, example_batch(n_sigs=8, n_nodes=4, device=device)


def dryrun_multichip(n_devices: int) -> dict:
    """Run the sharded admission step over ``n_devices`` CPU chunks: the
    signature batch split into ``n_devices`` contiguous chunks, the quorum
    tensors replicated, the validator axis of the ballot tally split, each
    result equal to the unsharded step (``models.admission.
    dryrun_sharded``).  This is what the JAX ``dryrun_multichip`` does on
    its virtual n-device CPU mesh; torch has no backend to pin, so it runs
    in this process.  The CPU is this function's explicit route: the
    chunks run the plain torch verify."""
    import torch

    from .models.admission import dryrun_sharded

    return dryrun_sharded(n_devices, [torch.device("cpu")] * n_devices)
