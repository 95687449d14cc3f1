"""Batched SCP quorum-set math as plain torch ops.

Counterpart of the JAX package's ``ops/quorum.py`` (reference seam
``LocalNode::isQuorumSlice`` / ``isVBlocking`` / ``isQuorum``, ref
src/scp/LocalNode.h:58-78).  A 2-level quorum set is the same four tensors:

  - ``top_mem``   (N,)   bool  — top-level validator membership
  - ``top_thr``   ()     int32 — top-level threshold
  - ``inner_mem`` (K, N) bool  — inner-set validator membership (zero-padded)
  - ``inner_thr`` (K,)   int32 — inner thresholds (0 => padding slot, never
                                  satisfied, never counts)

Member counts are AND-then-sum over the node axis (``sum(dtype=int32)``)
instead of the JAX module's integer einsums: torch has no integer GEMM on
CUDA, and these ops run on the card.  ``contract_batch`` keeps the JAX
module's fixed N trips (a ``fori_loop`` there) with no host sync; the
``while_loop`` of ``contract_to_maximal_quorum`` / ``federated_ratify``
stops at the fixpoint, checked on the host after every trip (exact: a trip
can only drop nodes, so once one changes nothing no later trip does).
``vmap`` becomes a written-out batch axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import default_device

I32 = torch.int32


class QSetTensor(NamedTuple):
    """One quorum set (or a batch of them, leading axis) in tensor form."""

    top_mem: torch.Tensor    # bool  (..., N)
    top_thr: torch.Tensor    # int32 (...,)
    inner_mem: torch.Tensor  # bool  (..., K, N)
    inner_thr: torch.Tensor  # int32 (..., K)


def local_qset(qt: QSetTensor, i: int) -> QSetTensor:
    """Node ``i``'s unbatched qset out of a batched QSetTensor."""
    return QSetTensor(qt.top_mem[i], qt.top_thr[i], qt.inner_mem[i],
                      qt.inner_thr[i])


def _hits(qs: QSetTensor, sets: torch.Tensor) -> torch.Tensor:
    """#top-level members (validators + inner sets) satisfied by each set.

    sets: bool (..., S, N); returns int32 (..., S)."""
    top = (qs.top_mem[..., None, :] & sets).sum(dim=-1, dtype=I32)
    inner_ct = (qs.inner_mem[..., None, :, :] & sets[..., :, None, :]).sum(
        dim=-1, dtype=I32)                                    # (..., S, K)
    thr = qs.inner_thr[..., None, :]
    inner_ok = (inner_ct >= thr) & (thr > 0)
    return top + inner_ok.sum(dim=-1, dtype=I32)


def is_quorum_slice(qs: QSetTensor, sets: torch.Tensor) -> torch.Tensor:
    """Does each node-set contain a slice of ``qs``?  bool (..., S)."""
    return _hits(qs, sets) >= qs.top_thr[..., None]


def is_v_blocking(qs: QSetTensor, sets: torch.Tensor) -> torch.Tensor:
    """Is each node-set v-blocking for ``qs``?  bool (..., S).
    threshold == 0 (empty qset) is never blocked."""
    avail = _hits(qs, ~sets)
    thr = qs.top_thr[..., None]
    return (avail < thr) & (thr > 0)


def _contract_trip(qsets: QSetTensor, m: torch.Tensor) -> torch.Tensor:
    """One contraction trip: node i stays in row b of ``m`` (B, N) iff its
    slice is satisfied inside row b."""
    # node i vs row b: (B, N) through the node-batched qsets
    sat = is_quorum_slice(qsets, m[:, None, None, :].expand(
        -1, m.shape[-1], 1, -1))[..., 0]
    return m & sat


def contract_batch(qsets: QSetTensor, members: torch.Tensor) -> torch.Tensor:
    """Greatest-fixpoint contraction of each row: members (B, N) -> (B, N).

    qsets: batched QSetTensor with leading axis N (one qset per node).
    Node i stays in row b iff its slice is satisfied inside row b; N
    fixed trips reach the fixpoint (ref contractToMaximalQuorum,
    src/herder/QuorumIntersectionCheckerImpl.cpp:407)."""
    m = members
    for _ in range(m.shape[-1]):
        m = _contract_trip(qsets, m)
    return m


def contract_fixpoint(qsets: QSetTensor, members: torch.Tensor
                      ) -> torch.Tensor:
    """``contract_batch``'s rows, stopping at the first trip that changed no
    row, and after N trips at most.  Each trip's check syncs the device
    with the host."""
    m = members
    for _ in range(members.shape[-1]):
        nxt = _contract_trip(qsets, m)
        if torch.equal(nxt, m):
            break
        m = nxt
    return m


def contract_to_maximal_quorum(qsets: QSetTensor,
                               members: torch.Tensor) -> torch.Tensor:
    """Maximal quorum inside ``members`` (N,) -> (N,), all-False if none."""
    return contract_fixpoint(qsets, members[None, :])[0]


def is_quorum(local_qs: QSetTensor, qsets: QSetTensor,
              members: torch.Tensor) -> torch.Tensor:
    """Does ``members`` contain a quorum w.r.t. the local node?  Contract to
    the maximal sub-quorum, then require it non-empty AND satisfying the
    local node's slice.  Returns a 0-d bool tensor."""
    q = contract_to_maximal_quorum(qsets, members)
    return q.any() & is_quorum_slice(local_qs, q[None, :])[0]


# ---------------------------------------------------------------------------
# federated-voting tallies (the BallotProtocol hot loop, batched)
# ---------------------------------------------------------------------------

def federated_ratify(local_qs: QSetTensor, qsets: QSetTensor,
                     voted: torch.Tensor) -> torch.Tensor:
    """A quorum that satisfies the local slice voted for each of C
    statements: voted (C, N) -> bool (C,).  ``local_qs`` may carry a
    leading batch axis V (one local node each) -> bool (V, C).  The
    contraction stops at the fixpoint (``contract_fixpoint``)."""
    q = contract_fixpoint(qsets, voted)                       # (C, N)
    return q.any(dim=-1) & is_quorum_slice(local_qs, q)


def federated_accept(local_qs: QSetTensor, qsets: QSetTensor,
                     voted: torch.Tensor, accepted: torch.Tensor,
                     ratified: torch.Tensor = None) -> torch.Tensor:
    """Accept iff a v-blocking set accepted, or a quorum voted-or-accepted
    (ref Slot::federatedAccept, src/scp/Slot.h:188).  ``ratified`` is an
    optional precomputed ``federated_ratify(local_qs, qsets,
    voted | accepted)``.  Shapes as ``federated_ratify``."""
    vblock = is_v_blocking(local_qs, accepted)
    if ratified is None:
        ratified = federated_ratify(local_qs, qsets, voted | accepted)
    return vblock | ratified


# ---------------------------------------------------------------------------
# host-side construction from python quorum-set descriptions
# ---------------------------------------------------------------------------

def build_qset_tensor(qsets, node_ids, max_inner=None,
                      device=None) -> QSetTensor:
    """Pack python quorum sets ``(threshold, validators, inner_sets)`` (inner
    sets ``(threshold, validators)``, 2-level) into a batched QSetTensor
    over the ordered universe ``node_ids``, on ``device`` (default: the
    GPU; see ``utils.device.default_device``)."""
    idx = {n: i for i, n in enumerate(node_ids)}
    n = len(node_ids)
    k = max_inner or max((len(q[2]) for q in qsets), default=0) or 1
    b = len(qsets)
    top_mem = np.zeros((b, n), np.bool_)
    top_thr = np.zeros((b,), np.int32)
    inner_mem = np.zeros((b, k, n), np.bool_)
    inner_thr = np.zeros((b, k), np.int32)
    for i, (thr, vals, inners) in enumerate(qsets):
        top_thr[i] = thr
        for v in vals:
            top_mem[i, idx[v]] = True
        for j, (ithr, ivals) in enumerate(inners):
            inner_thr[i, j] = ithr
            for v in ivals:
                inner_mem[i, j, idx[v]] = True
    return qset_from_numpy(top_mem, top_thr, inner_mem, inner_thr,
                           default_device(device))


def qset_from_numpy(top_mem, top_thr, inner_mem, inner_thr,
                    device) -> QSetTensor:
    """QSetTensor on ``device`` from four numpy arrays (the JAX tensors'
    fields as numpy), with the port's dtypes."""
    return QSetTensor(
        torch.as_tensor(np.array(top_mem, np.bool_), device=device),
        torch.as_tensor(np.array(top_thr, np.int32), device=device),
        torch.as_tensor(np.array(inner_mem, np.bool_), device=device),
        torch.as_tensor(np.array(inner_thr, np.int32), device=device))
