"""The transaction-admission step on the port: batched ed25519 verify
through the hand-written CUDA kernel, plus federated-voting tallies.

Counterpart of the JAX package's ``models/admission.py``: one step that
  1. verifies a batch of ed25519 signatures (the ``PubKeyUtils::verifySig``
     seam, ref src/crypto/SecretKey.cpp:428) — ``ops/ed25519_cuda`` launches
     the kernel for CUDA tensors and runs the plain torch version for CPU
     tensors;
  2. runs federated accept/ratify for C candidate statements over the
     validator universe (``LocalNode::isQuorum``/``isVBlocking``, ref
     src/scp/LocalNode.h:58-78).

The verify applies the full libsodium verdict, small-order blacklist
included.  The JAX step calls ``_verify_impl``, which has no blacklist; the
two agree on every batch without a small-order A or R encoding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import ed25519_cuda
from ..ops import quorum as Q
from ..parallel import data_parallel_devices, dp, replicated
from ..utils.device import cpu_threads, default_device


class AdmissionBatch(NamedTuple):
    pubkeys: torch.Tensor     # (S, 32) uint8
    sigs: torch.Tensor        # (S, 64) uint8
    msgs: torch.Tensor        # (S, 32) uint8
    qset: Q.QSetTensor        # batched per-node, leading axis N
    local_qset: Q.QSetTensor  # unbatched (the local node's qset)
    voted: torch.Tensor       # (C, N) bool
    accepted: torch.Tensor    # (C, N) bool


def admission_step(batch: AdmissionBatch):
    """One admission step: sig verify + federated-accept tally.

    Returns (sig_ok (S,) bool, accept (C,) bool, ratify (C,) bool)."""
    with cpu_threads(batch.pubkeys.device):
        sig_ok = ed25519_cuda.verify_batch(batch.pubkeys, batch.sigs,
                                           batch.msgs)
        ratify = Q.federated_ratify(batch.local_qset, batch.qset,
                                    batch.voted | batch.accepted)
        accept = Q.federated_accept(batch.local_qset, batch.qset,
                                    batch.voted, batch.accepted,
                                    ratified=ratify)
        return sig_ok, accept, ratify


def multi_validator_tally(qt: Q.QSetTensor, voted, accepted):
    """Ballot tallies for N simulated validators at once (BASELINE config
    #5): validator v evaluates federated accept/ratify against its own
    quorum set over the shared statement matrix.  The validator axis is a
    leading batch axis of the local qset; the contraction of
    ``voted | accepted`` does not depend on the validator, so it runs once.
    Returns (accept (N, C) bool, ratify (N, C) bool)."""
    return _tally(qt, qt, voted, accepted)


def _tally(local: Q.QSetTensor, qt: Q.QSetTensor, voted, accepted):
    """accept, ratify (V, C) of the validators whose qsets are ``local``
    (leading axis V) over the universe ``qt``."""
    ratify = Q.federated_ratify(local, qt, voted | accepted)
    accept = Q.federated_accept(local, qt, voted, accepted, ratified=ratify)
    return accept, ratify


def _u8(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.uint8, order="C"),
                           device=device)


def _bool(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.bool_), device=device)


def batch_from_numpy(pubkeys, sigs, msgs, qset, local_qset, voted, accepted,
                     device=None) -> AdmissionBatch:
    """AdmissionBatch on ``device`` (default: the GPU) from numpy arrays —
    the JAX batch's fields, so both packages can take identical inputs.
    ``qset`` and ``local_qset`` are each the four QSetTensor arrays
    (top_mem, top_thr, inner_mem, inner_thr)."""
    dev = default_device(device)
    return AdmissionBatch(_u8(pubkeys, dev), _u8(sigs, dev), _u8(msgs, dev),
                          Q.qset_from_numpy(*qset, dev),
                          Q.qset_from_numpy(*local_qset, dev),
                          _bool(voted, dev), _bool(accepted, dev))


def example_batch(n_sigs: int = 8, n_nodes: int = 4, device=None) -> tuple:
    """A real example batch (valid signatures, 2f+1-of-3f+1 quorums): the
    same bytes and votes as the JAX package's ``example_batch``."""
    from ..crypto import ed25519_ref as ref
    from ..crypto.sha import sha256

    pubs, sigs, msgs = [], [], []
    for i in range(n_sigs):
        seed = sha256(b"entry%d" % i)
        m = sha256(b"msg%d" % i)
        pubs.append(ref.public_from_seed(seed))
        sigs.append(ref.sign(seed, m))
        msgs.append(m)
    pk = np.frombuffer(b"".join(pubs), np.uint8).reshape(n_sigs, 32)
    sg = np.frombuffer(b"".join(sigs), np.uint8).reshape(n_sigs, 64)
    mg = np.frombuffer(b"".join(msgs), np.uint8).reshape(n_sigs, 32)

    dev = default_device(device)
    nodes = list(range(n_nodes))
    thr = n_nodes - n_nodes // 3  # 2f+1 of 3f+1
    qt = Q.build_qset_tensor([(thr, nodes, []) for _ in nodes], nodes,
                             device=dev)
    rng = np.random.default_rng(3)
    c = 4
    voted = _bool(rng.random((c, n_nodes)) < 0.8, dev)
    accepted = _bool(rng.random((c, n_nodes)) < 0.5, dev)
    batch = AdmissionBatch(_u8(pk, dev), _u8(sg, dev), _u8(mg, dev), qt,
                           Q.local_qset(qt, 0), voted, accepted)
    return (batch,)


# ---------------------------------------------------------------------------
# data-parallel layout (the JAX package shards the same step over a mesh)
# ---------------------------------------------------------------------------

def _qset_dp(qt: Q.QSetTensor, devs) -> list:
    return [Q.QSetTensor(*t) for t in zip(*(dp(x, devs) for x in qt))]


def _qset_replicated(qt: Q.QSetTensor, devs) -> list:
    return [Q.QSetTensor(*t) for t in zip(*(replicated(x, devs) for x in qt))]


def _sync(devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sharded_admission_step(batch: AdmissionBatch, devices):
    """``admission_step`` with the signature batch split over ``devices``
    (``parallel.dp``) and the quorum tensors and statement matrices
    replicated on each: every device verifies its chunk and tallies the
    replicated statements.  The verdicts are concatenated on
    ``devices[0]``; the replicated accept/ratify results must agree across
    devices (AssertionError otherwise).  Returns what ``admission_step``
    returns."""
    devs = [torch.device(d) for d in devices]
    pk, sg, mg = (dp(x, devs) for x in (batch.pubkeys, batch.sigs,
                                        batch.msgs))
    qset, local = (_qset_replicated(q, devs)
                   for q in (batch.qset, batch.local_qset))
    voted, accepted = (replicated(x, devs)
                       for x in (batch.voted, batch.accepted))
    outs = [admission_step(AdmissionBatch(pk[i], sg[i], mg[i], qset[i],
                                          local[i], voted[i], accepted[i]))
            for i in range(len(devs))]
    home = devs[0]
    sig_ok = torch.cat([o[0].to(home) for o in outs])
    accept, ratify = outs[0][1], outs[0][2]
    for o in outs[1:]:
        if not (torch.equal(o[1].to(home), accept)
                and torch.equal(o[2].to(home), ratify)):
            raise AssertionError("replicated accept/ratify differ between "
                                 "devices")
    return sig_ok, accept, ratify


def sharded_multi_validator_tally(qt: Q.QSetTensor, voted, accepted,
                                  devices):
    """``multi_validator_tally`` with the validator axis split over
    ``devices``: each device tallies its contiguous slice of validators
    against the replicated universe and statements.  Returns (accept,
    ratify) (N, C) on ``devices[0]``."""
    devs = [torch.device(d) for d in devices]
    local = _qset_dp(qt, devs)
    universe = _qset_replicated(qt, devs)
    v, a = replicated(voted, devs), replicated(accepted, devs)
    outs = [_tally(local[i], universe[i], v[i], a[i])
            for i in range(len(devs))]
    return tuple(torch.cat([o[k].to(devs[0]) for o in outs])
                 for k in range(2))


def _uniform_tally_inputs(n_validators: int, n_candidates: int, device):
    nodes = list(range(n_validators))
    thr = n_validators - n_validators // 3
    qt = Q.build_qset_tensor([(thr, nodes, []) for _ in nodes], nodes,
                             device=device)
    rng = np.random.default_rng(11)
    voted = _bool(rng.random((n_candidates, n_validators)) < 0.8, device)
    accepted = _bool(rng.random((n_candidates, n_validators)) < 0.5, device)
    return qt, voted, accepted


def bench_sharded(n_devices: int | None = None, n_sigs: int = 100_000,
                  n_validators: int = 64, n_candidates: int = 64,
                  reps: int = 1, workload_npz: str | None = None,
                  devices=None) -> dict:
    """Bench-shaped data-parallel admission: a ``n_sigs`` verify batch
    split over ``n_devices`` devices (default: every visible CUDA device;
    ``devices`` names others) and a ``n_validators`` ballot tally with the
    validator axis split; returns the JAX ``bench_sharded``'s keys
    (``device_kind``: the card's name).  ``workload_npz`` holds ``pk``,
    ``sg``, ``mg`` of at least ``n_sigs`` rows (as the JAX one reads it);
    without it the batch is signed here.  Every verdict must be true.
    Times are host-clock seconds with every device synchronised;
    ``verify_compile_s`` is the first call's, which builds the kernel."""
    import time

    devs = data_parallel_devices(n_devices, devices)
    n_devices = len(devs)

    if workload_npz:
        d = np.load(workload_npz)
        pk, sg, mg = d["pk"][:n_sigs], d["sg"][:n_sigs], d["mg"][:n_sigs]
        assert pk.shape[0] == n_sigs, "workload smaller than n_sigs"
    else:
        from ..crypto import SecretKey, sha256

        keys = [SecretKey(sha256(b"mcb%d" % i)) for i in range(64)]
        rng = np.random.default_rng(7)
        mg = rng.integers(0, 256, (n_sigs, 32), dtype=np.uint8)
        pk = np.empty((n_sigs, 32), np.uint8)
        sg = np.empty((n_sigs, 64), np.uint8)
        for i in range(n_sigs):
            k = keys[i % 64]
            pk[i] = np.frombuffer(k.public_key().raw, np.uint8)
            sg[i] = np.frombuffer(k.sign(bytes(mg[i])), np.uint8)
    chunks = [dp(_u8(x, "cpu"), devs) for x in (pk, sg, mg)]

    def verify():
        return [ed25519_cuda.verify_batch(*(c[i] for c in chunks))
                for i in range(n_devices)]

    t0 = time.perf_counter()
    ok = torch.cat([o.cpu() for o in verify()])
    compile_s = time.perf_counter() - t0
    assert ok.all(), "sharded verify rejected valid signatures"
    t0 = time.perf_counter()
    for _ in range(reps):
        verify()
    _sync(devs)
    verify_dt = (time.perf_counter() - t0) / reps

    qt, voted, accepted = _uniform_tally_inputs(n_validators, n_candidates,
                                                devs[0])
    t0 = time.perf_counter()
    acc, rat = sharded_multi_validator_tally(qt, voted, accepted, devs)
    _sync(devs)
    tally_compile_s = time.perf_counter() - t0
    tally_reps = max(reps, 10)
    t0 = time.perf_counter()
    for _ in range(tally_reps):
        acc, rat = sharded_multi_validator_tally(qt, voted, accepted, devs)
    _sync(devs)
    tally_dt = (time.perf_counter() - t0) / tally_reps
    assert acc.shape == (n_validators, n_candidates)

    dev0 = devs[0]
    return {
        "n_devices": n_devices,
        "device_kind": (torch.cuda.get_device_name(dev0)
                        if dev0.type == "cuda" else dev0.type),
        "platform": dev0.type,
        "n_signatures": n_sigs,
        "verify_compile_s": round(compile_s, 1),
        "verify_step_s": round(verify_dt, 3),
        "verify_sigs_per_s": round(n_sigs / verify_dt, 1),
        "verify_sigs_per_s_per_device": round(
            n_sigs / verify_dt / n_devices, 1),
        "n_validators": n_validators,
        "n_candidates": n_candidates,
        "tally_compile_s": round(tally_compile_s, 2),
        "tally_step_s": round(tally_dt, 5),
        "validator_tallies_per_s": round(
            n_validators * n_candidates / tally_dt, 1),
    }


def dryrun_sharded(n_devices: int, devices=None) -> dict:
    """Run the full admission step once over ``n_devices`` devices (the
    first of ``devices``, default the visible CUDA devices) on tiny shapes:
    the signature batch split, the quorum tensors replicated
    (``sharded_admission_step``), then the validator-parallel ballot tally
    of ``4 * n_devices`` validators with the validator axis split.  Every verdict must be true and each sharded
    result must equal the unsharded step on ``devices[0]``
    (AssertionError otherwise).  Returns the sharded results:
    ``sig_ok``, ``accept``, ``ratify``, ``tally_accept``, ``tally_ratify``."""
    devs = data_parallel_devices(n_devices, devices)
    home = devs[0]
    (batch,) = example_batch(n_sigs=2 * n_devices, n_nodes=4, device=home)
    sig_ok, accept, ratify = sharded_admission_step(batch, devs)
    assert bool(sig_ok.all()), "sharded verify rejected valid signatures"
    for got, want in zip((sig_ok, accept, ratify), admission_step(batch)):
        assert torch.equal(got, want), "sharded step != unsharded step"

    n_validators = 4 * n_devices
    qt, voted, accepted = _uniform_tally_inputs(n_validators, 8, home)
    acc, rat = sharded_multi_validator_tally(qt, voted, accepted, devs)
    assert acc.shape == (n_validators, 8)
    for got, want in zip((acc, rat),
                         multi_validator_tally(qt, voted, accepted)):
        assert torch.equal(got, want), "sharded tally != unsharded tally"
    return {"sig_ok": sig_ok, "accept": accept, "ratify": ratify,
            "tally_accept": acc, "tally_ratify": rat}
