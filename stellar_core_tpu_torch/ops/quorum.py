"""Batched SCP quorum-set math as plain torch ops.

Counterpart of the JAX package's ``ops/quorum.py`` (reference seam
``LocalNode::isQuorumSlice`` / ``isVBlocking`` / ``isQuorum``, ref
src/scp/LocalNode.h:58-78).  A 2-level quorum set is the same four tensors:

  - ``top_mem``   (N,)   bool  — top-level validator membership
  - ``top_thr``   ()     int32 — top-level threshold
  - ``inner_mem`` (K, N) bool  — inner-set validator membership (zero-padded)
  - ``inner_thr`` (K,)   int32 — inner thresholds (0 => padding slot, never
                                  satisfied, never counts)

Member counts are the JAX module's einsums as float32 products of 0/1
values (``_counts``): torch has no integer GEMM on CUDA, and a float32 sum
of 0/1 values is exact while it stays below 2^24, far above any node count.
The products never allocate more than the JAX einsums' (B, N, K); one
unbatched qset (the live tally's local node) ANDs and sums (S, K, N)
instead, which costs the card's host less at those sizes.
``contract_batch`` keeps the JAX module's fixed N trips (a ``fori_loop``
there) with no host sync; the ``while_loop`` of
``contract_to_maximal_quorum`` / ``federated_ratify`` stops at the
fixpoint, checked on the host after every trip (exact: a trip can only drop
nodes, so once one changes nothing no later trip does).  ``vmap`` becomes a
written-out batch axis.

``SharedSets`` / ``contract_shared`` are the quorum-intersection scan's
form of the same contraction: every distinct (threshold, members) element
of the node-batched qsets is counted once per row, and each node adds up
the elements its qset lists, which gives ``contract_batch``'s rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import default_device

I32 = torch.int32
F32 = torch.float32


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


def _members(qs: QSetTensor) -> torch.Tensor:
    """The top-level validators as row 0 above the K inner sets: bool
    (..., K + 1, N), so that one product counts all of them."""
    return torch.cat([qs.top_mem[..., None, :], qs.inner_mem], dim=-2)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 even inside an autocast region, where it would
    come out in bf16 or fp16 (integers exact only to 256 and 2,048)."""
    if torch.is_autocast_enabled(a.device.type):
        with torch.autocast(a.device.type, enabled=False):
            return a @ b
    return a @ b


def _counts(sets: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
    """Members of each row of ``mem`` in each set: sets bool (..., S, N),
    mem bool (..., R, N) -> float32 (..., S, R).  A float32 product of 0/1
    values: exact integers below 2^24, so that comparing them with the
    int32 thresholds is exact."""
    return _matmul(sets.to(F32), mem.to(F32).transpose(-1, -2))


def _hits(qs: QSetTensor, sets: torch.Tensor) -> torch.Tensor:
    """#top-level members (validators + inner sets) satisfied by each set.

    sets: bool (..., S, N); returns int32 (..., S).  One qset (the live
    tally's local node) ANDs and sums (..., S, K, N), which costs the
    card's host less than a product at those sizes; a batch of qsets takes
    one product, since broadcasting the AND would build (..., S, K, N) for
    every qset of the batch."""
    if qs.top_mem.dim() == 1:
        top = (qs.top_mem & sets).sum(dim=-1, dtype=I32)
        inner_ct = (qs.inner_mem & sets[..., :, None, :]).sum(dim=-1,
                                                               dtype=I32)
    else:
        ct = _counts(sets, _members(qs)).to(I32)          # (..., S, K + 1)
        top, inner_ct = ct[..., 0], ct[..., 1:]
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
    slice is satisfied inside row b (the JAX ``in,bn->bi`` and
    ``ikn,bn->bik`` einsums)."""
    b, n = m.shape
    ct = _counts(m, _members(qsets).reshape(-1, n)).reshape(b, n, -1)
    top, inner_ct = ct[..., 0], ct[..., 1:]                 # (B, N), (B, N, K)
    thr = qsets.inner_thr[None]                             # (1, N, K)
    hits = top + ((inner_ct >= thr) & (thr > 0)).sum(dim=-1, dtype=I32)
    return m & (hits >= qsets.top_thr[None])


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


class SharedSets(NamedTuple):
    """Node-batched 2-level qsets with each distinct element once: a
    top-level validator v is the element ({v}, 1), an inner set with a
    threshold above 0 the element (members, threshold); padding never
    counts, so it has no element."""

    mem: torch.Tensor      # float32 (U, N): the members of each element
    thr: torch.Tensor      # float32 (U,): its threshold
    use: torch.Tensor      # float32 (U, N): how often node i's qset lists it
    top_thr: torch.Tensor  # float32 (N,): each node's top-level threshold


def shared_sets(qsets, node_ids, device) -> SharedSets:
    """``SharedSets`` of python quorum sets ``(threshold, validators,
    inner_sets)`` over the ordered universe ``node_ids`` (as
    ``build_qset_tensor`` takes them), on ``device``.  Counts as the
    dense form does: a validator listed twice is one member, an inner set
    listed twice counts twice."""
    idx = {v: i for i, v in enumerate(node_ids)}
    n = len(node_ids)
    elems: dict = {}   # (threshold, member columns) -> element row
    uses = []          # (element row, node column), one per listing
    top_thr = np.zeros(n, np.float32)
    for i, (thr, vals, inners) in enumerate(qsets):
        top_thr[i] = thr
        keys = [(1, (j,)) for j in sorted({idx[v] for v in vals})]
        keys += [(t, tuple(sorted({idx[v] for v in vs})))
                 for t, vs in inners if t > 0]
        uses += [(elems.setdefault(key, len(elems)), i) for key in keys]
    u = max(len(elems), 1)
    mem = np.zeros((u, n), np.float32)
    thr = np.ones(u, np.float32)
    for (t, cols), e in elems.items():
        thr[e] = t
        mem[e, list(cols)] = 1
    use = np.zeros((u, n), np.float32)
    if uses:
        np.add.at(use, tuple(np.array(uses).T), 1)
    return SharedSets(*(torch.as_tensor(a, device=device)
                        for a in (mem, thr, use, top_thr)))


def _shared_trip(ss: SharedSets, m: torch.Tensor) -> torch.Tensor:
    """``_contract_trip`` through the distinct elements: (B, N) @ (N, U)
    counts, the (B, U) satisfied elements, and (B, U) @ (U, N) each
    node's satisfied listings; float32 products of small integers, exact."""
    sat = (_matmul(m.to(F32), ss.mem.T) >= ss.thr).to(F32)       # (B, U)
    return m & (_matmul(sat, ss.use) >= ss.top_thr)            # (B, N)


def contract_shared(ss: SharedSets, members: torch.Tensor) -> torch.Tensor:
    """``contract_fixpoint``'s rows for the qsets of ``ss``: members (B, N)
    -> (B, N), stopping at the first trip that changed no row."""
    m = members
    for _ in range(members.shape[-1]):
        nxt = _shared_trip(ss, m)
        if torch.equal(nxt, m):
            break
        m = nxt
    return m


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
