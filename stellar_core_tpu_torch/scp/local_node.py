"""Local node: identity + quorum-set threshold math.

Host-side exact reference for the quorum predicates (ref
src/scp/LocalNode.h:58-78, LocalNode.cpp).  The batched device versions of the
same predicates live in ``ops/quorum.py`` (QSetTensor) — this module is the
oracle they are tested against and the path used for one-off host checks;
``to_tensor``/``pack_universe`` bridge the two.

Node ids are raw 32-byte ed25519 public keys (bytes).  Quorum sets are XDR
``SCPQuorumSet`` values (xdr/types.py) — at most 2 levels deep, like the wire
format enforces.
"""
from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Set

from ..xdr import types as T, xdr_sha256
from . import qset_vector


def qset_hash(qset) -> bytes:
    return xdr_sha256(T.SCPQuorumSet, qset)


def node_key(node_id_value) -> bytes:
    """XDR NodeID value -> raw 32-byte key."""
    return node_id_value.value


def make_qset(threshold: int, validators: Iterable[bytes],
              inner: Iterable = ()) -> object:
    return T.SCPQuorumSet.make(
        threshold=threshold,
        validators=[T.account_id(v) for v in validators],
        innerSets=list(inner),
    )


def qset_nodes(qset) -> Set[bytes]:
    """All node ids appearing anywhere in the qset tree."""
    out = {node_key(v) for v in qset.validators}
    for inner in qset.innerSets:
        out |= qset_nodes(inner)
    return out


def is_quorum_slice(qset, nodes: Set[bytes]) -> bool:
    """Does ``nodes`` contain a slice of ``qset``?  (threshold hits among
    validators + recursively-satisfied inner sets).  Early-exits at the
    threshold: at 50-validator scale this predicate dominates whole
    consensus rounds (profiled 31s/round before, most of it generator
    overhead past an already-met threshold)."""
    thr = qset.threshold
    hits = 0
    for v in qset.validators:
        if v.value in nodes:
            hits += 1
            if hits >= thr:
                return True
    for s in qset.innerSets:
        if is_quorum_slice(s, nodes):
            hits += 1
            if hits >= thr:
                return True
    return hits >= thr


def is_v_blocking(qset, nodes: Set[bytes]) -> bool:
    """Does ``nodes`` intersect every slice of ``qset``?  Computed as: the
    members still available after removing ``nodes`` cannot reach the
    threshold.  An empty threshold is never blocked."""
    if qset.threshold == 0:
        return False
    avail = sum(1 for v in qset.validators if node_key(v) not in nodes)
    avail += sum(
        1 for s in qset.innerSets if not is_v_blocking(s, nodes)
    )
    return avail < qset.threshold


def is_quorum(
    members: Set[bytes],
    get_qset: Callable[[bytes], Optional[object]],
    local_qset=None,
) -> bool:
    """Greatest-fixpoint quorum check: contract ``members`` by dropping nodes
    whose qset has no slice inside the set; a non-empty fixpoint equal to the
    full contraction that also satisfies ``local_qset`` (when given) is a
    quorum.  Nodes with unknown qsets never count."""
    if qset_vector._ENABLED and len(members) >= qset_vector._MIN_NODES:
        # large member sets take the vectorized matrix-fixpoint path
        # (scp/qset_vector.py) — exact integer math, bitwise-identical
        # verdicts, with memo caches shared across every sim node in
        # the process.  None means "not applicable" (a >2-level qset in
        # play): fall through to the scalar oracle.
        v = qset_vector.vector_is_quorum(members, get_qset, local_qset)
        if v is not None:
            return v
    cur = set(members)
    while True:
        # within one contraction step ``cur`` is fixed, so the slice
        # verdict is a pure function of the qset VALUE — and in real
        # topologies most nodes share one qset object (PendingEnvelopes
        # dedups by hash), so memoizing by identity turns N identical
        # recursive evaluations into one per step.  The cache dies with
        # the step: ``cur`` changes invalidate it wholesale.
        verdicts: Dict[int, bool] = {}
        nxt = set()
        for n in sorted(cur):
            q = get_qset(n)
            if q is None:
                continue
            # id() is only a memo key; the verdict is a pure function of
            # the qset VALUE, so which object's id wins a slot never
            # changes any result
            # detlint: allow(det-interproc-taint)
            v = verdicts.get(id(q))
            if v is None:
                # detlint: allow(det-interproc-taint) — same memo key
                v = verdicts[id(q)] = is_quorum_slice(q, cur)
            if v:
                nxt.add(n)
        if nxt == cur:
            break
        cur = nxt
    if not cur:
        return False
    if local_qset is not None and not is_quorum_slice(local_qset, cur):
        return False
    return True


def find_closest_v_blocking(
    qset, nodes: Set[bytes], excluded: Optional[bytes] = None
) -> Optional[List[bytes]]:
    """A small subset of ``nodes`` that is v-blocking for ``qset`` (greedy
    minimal; ref LocalNode::findClosestVBlocking — used by the out-of-sync
    heuristics).  Returns None when ``nodes`` cannot block ``qset``.

    To make a qset with m members and threshold t unsatisfiable, block
    m - t + 1 members; each validator in ``nodes`` blocks itself, each inner
    set is blocked by its own closest v-blocking subset.
    """
    members = len(qset.validators) + len(qset.innerSets)
    need = members - qset.threshold + 1
    if qset.threshold == 0:
        return None  # threshold 0 is always satisfied, cannot block
    candidates: List[List[bytes]] = []
    for v in qset.validators:
        k = node_key(v)
        if k != excluded and k in nodes:
            candidates.append([k])
    for s in qset.innerSets:
        inner = find_closest_v_blocking(s, nodes, excluded)
        if inner is not None:
            candidates.append(inner)
    if len(candidates) < need:
        return None
    candidates.sort(key=len)
    out: List[bytes] = []
    for c in candidates[:need]:
        out.extend(c)
    return out


class LocalNode:
    """Identity + qset of this validator (ref src/scp/LocalNode.h)."""

    def __init__(self, node_id: bytes, qset, is_validator: bool = True,
                 secret=None):
        self.node_id = node_id
        self.qset = qset
        self.qset_hash = qset_hash(qset)
        self.is_validator = is_validator
        self.secret = secret  # SecretKey or None (observer)

    def update_qset(self, qset) -> None:
        self.qset = qset
        self.qset_hash = qset_hash(qset)


# ---------------------------------------------------------------------------
# bridge to the tensor kernels (ops/quorum.py)
# ---------------------------------------------------------------------------

def qset_to_plain(qset) -> Optional[tuple]:
    """XDR SCPQuorumSet -> (threshold, [ids], [(thr, [ids])]) for
    ops.quorum.build_qset_tensor.

    The tensor form covers 2-level sets (every production validator's
    shape); the protocol legally allows depth 4
    (ref src/scp/QuorumSetUtils.cpp:16), so deeper sets return None and the
    caller must fall back to the exact host math in this module."""
    inners = []
    for s in qset.innerSets:
        if s.innerSets:
            return None  # >2 levels: tensor form unavailable
        inners.append((s.threshold, [node_key(v) for v in s.validators]))
    return (qset.threshold, [node_key(v) for v in qset.validators], inners)
