"""A peer's transaction set validated from its wire bytes, once a step.

Set-up makes the set once from the seed: ``signatures`` single-payment
envelopes from ``signers`` accounts (each account's envelopes at
consecutive sequence numbers), ``forged`` of them at positions drawn from
the seed with a forged signature, as one ``TransactionSet``'s bytes.  It
then runs the workload's warm-up steps, which build the verify kernel and
launch it at the set's padded batch size.

A step empties the host's verify cache (not timed), then decodes the set
(``TransactionSet.decode`` and ``TxSetFrame.make_from_wire``: span
``decode``) and validates every signature with
``TxSetFrame.prevalidate_signatures(use_device=True)`` (span
``prevalidate``), which returns once the verdicts are read back.
"""
from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np

from .. import node
from ..traffic import Traffic, tx_set

MISSING = 2


def setup(ctx):
    wl = ctx.workload
    passphrase = ctx.config["node"]["NETWORK_PASSPHRASE"]
    t = Traffic(ctx.seed, passphrase, wl["signers"], 0, wl["amount_max"])
    n, k = wl["signatures"], wl["signers"]
    sources = [j % k for j in range(n)]
    seqs = [(2 << 32) + 1 + j // k for j in range(n)]
    envs = t.payments(sources, seqs, wl["forged"])
    st = SimpleNamespace(envs=envs, net_id=t.net_id, got=[], extra=0,
                         verdicts=None)
    st.wire = tx_set(t.rng.bytes(32), [e.wire for e in envs])
    st.triples = [(e.pub, e.sig, e.hash) for e in envs]
    ctx.counters["signatures_per_step"] = n
    ctx.counters["verify_rows"] = tuple(
        np.frombuffer(b"".join(col), np.uint8).reshape(n, -1)
        for col in zip(*st.triples))
    for _ in range(wl["warmup_steps"]):
        prepare(ctx, st, -1)
        step(ctx, st, -1)
    st.verdicts = None
    # the set's 100,000 envelopes and triples live as long as the run:
    # out of the collector's reach, so that the collections the decode
    # triggers never traverse the benchmark's own objects
    gc.collect()
    gc.freeze()
    return st


def window_open(ctx, st) -> None:
    pass


def prepare(ctx, st, i) -> None:
    from stellar_core_tpu_torch.crypto import ed25519

    st.verdicts = None
    ed25519.clear_verify_cache()


def step(ctx, st, i) -> None:
    from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
    from stellar_core_tpu_torch.xdr import types as T

    with ctx.span("decode"):
        frame = TxSetFrame.make_from_wire(
            st.net_id, T.TransactionSet.decode(st.wire))
    with ctx.span("prevalidate"):
        st.verdicts = frame.prevalidate_signatures(use_device=True,
                                                   device=ctx.device)


def after(ctx, st, i) -> None:
    """Keep the step's verdicts in the set's order (``MISSING`` where the
    program gave none) and the count of verdicts for triples the set does
    not hold; drop the program's dict, so that no step's output lingers
    for the next step's collections."""
    got = np.fromiter((st.verdicts.get(tr, MISSING) for tr in st.triples),
                      np.int8, len(st.triples))
    st.extra += len(st.verdicts) - int((got != MISSING).sum())
    st.got.append(got)
    st.verdicts = None
    ctx.attempted += len(st.triples)


def window_close(ctx, st) -> None:
    pass


def collect(ctx, st) -> dict:
    return {"got": st.got, "extra": st.extra, "envs": st.envs}


def judge(ctx, out) -> dict:
    """Every verdict of every step against the signature the traffic made
    (true unless forged), that truth held against the plain reference's
    verify on a sample drawn from the seed."""
    want = np.array([not e.forged for e in out["envs"]], np.int8)
    missing = wrong = 0
    for got in out["got"]:
        missing += int((got == MISSING).sum())
        wrong += int(((got != MISSING) & (got != want)).sum())
    ctx.failed = missing + wrong
    return {
        "triples_missing": (missing, 0),
        "triples_extra": (out["extra"], 0),
        "verdicts_wrong": (wrong, 0),
        "reference_disagrees": (node.sample_disagrees(
            out["envs"], ctx.seed, ctx.workload["sample_per_kind"]), 0),
    }
