"""Faults that break the program's timed path from inside the benchmark's
process, for the window only: the control and the fault tests.  Each
wraps a function of the port at run time and puts it back afterwards; no
file of the port changes.

- ``accept_all``: every signature verdict true, on the host
  (``crypto.ed25519.raw_verify``) and on the device
  (``ops.ed25519_cuda.verify_batch``): the guarantee that every forged
  envelope is refused is broken.
- ``drop_half``: every second envelope submitted to a node is left out
  while the node answers that it took it; every second verdict of a
  set's signature batch is left out.
- ``unchanged``: a step that returns with the state unchanged: no ledger
  closes, or the set's signature batch verifies nothing.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def accept_all(ctx):
    import torch

    from stellar_core_tpu_torch.crypto import ed25519
    from stellar_core_tpu_torch.ops import ed25519_cuda

    def host(real):
        return lambda pub, sig, msg: True

    def device(real):
        def verify_batch(pk, sg, mg, *args, **kw):
            out = real(pk, sg, mg, *args, **kw)
            return torch.ones_like(out)
        return verify_batch

    ed25519.clear_verify_cache()
    with _patched(ed25519, "raw_verify", host), \
            _patched(ed25519_cuda, "verify_batch", device):
        yield
    ed25519.clear_verify_cache()


@contextlib.contextmanager
def drop_half(ctx):
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    from stellar_core_tpu_torch.herder.tx_set import TxSetFrame

    seen = [0]

    def recv(real):
        def recv_transaction(self, env):
            seen[0] += 1
            if seen[0] % 2 == 0:
                return TransactionQueue.ADD_STATUS_PENDING
            return real(self, env)
        return recv_transaction

    def prevalidate(real):
        def prevalidate_signatures(self, *args, **kw):
            out = real(self, *args, **kw)
            return dict(list(out.items())[::2])
        return prevalidate_signatures

    with _patched(Herder, "recv_transaction", recv), \
            _patched(TxSetFrame, "prevalidate_signatures", prevalidate):
        yield


@contextlib.contextmanager
def unchanged(ctx):
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
    from stellar_core_tpu_torch.simulation.simulation import Simulation

    def close(real):
        def manual_close(self):
            return self.app.ledger_manager.last_closed_seq()
        return manual_close

    def sim_close(real):
        return lambda self, timeout=60.0: True

    def prevalidate(real):
        return lambda self, *args, **kw: {}

    with _patched(Herder, "manual_close", close), \
            _patched(Simulation, "close_ledger", sim_close), \
            _patched(TxSetFrame, "prevalidate_signatures", prevalidate):
        yield


FAULTS = {"accept_all": accept_all, "drop_half": drop_half,
          "unchanged": unchanged}
