"""stellar_core_tpu_torch — the PyTorch/CUDA port of the JAX package.

The JAX package ``stellar_core_tpu`` is the reference; this package is a
second implementation beside it that never imports ``jax`` nor anything of
that package.  It uses the same module names so each counterpart is easy to
find:

- ``crypto``  — own copies of the ed25519 spec (oracle, constants, signer)
                and ``sha256``
- ``ops``     — plain torch tensor ops (field/scalar/SHA-512/quorum math)
                and the hand-written Hopper kernel for batched ed25519
                verify (``ops/ed25519_cuda.py`` + ``csrc/ed25519_verify.cu``)
- ``utils``   — default-device resolution and signature-batch buckets;
                copies of ``tracing``, ``lockdep`` and ``logging``
- ``models``  — the transaction-admission step (verify + quorum tallies)
- ``xdr``     — a copy of the XDR runtime (pure-Python pack/unpack) and
                the protocol schema
- ``scp``     — a copy of the SCP consensus core; its ``tally.py`` runs
                the federated tallies on a device through ``ops/quorum``

Unlike the JAX package there is no global 64-bit switch: every dtype in the
port is explicit, so results do not depend on import order.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and
no explicit device they raise instead of silently running on the CPU.
"""

__version__ = "0.1.0"
