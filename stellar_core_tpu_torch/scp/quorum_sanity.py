"""Quorum-set sanity + normalization (ref src/scp/QuorumSetUtils.cpp).

Rules: threshold in [1, members] at every level, nesting depth <= 4, total
validators in [1, 1000], no duplicate nodes anywhere; extra_checks further
requires threshold > 50% of members (v-blocking safety margin).
"""
from __future__ import annotations

from typing import Optional, Set

from ..xdr import types as T

MAXIMUM_QUORUM_NESTING_LEVEL = 4
MAX_NODES_IN_QSET = 1000


def is_quorum_set_sane(qset, extra_checks: bool = False) -> bool:
    seen: Set[bytes] = set()
    count = [0]

    def check(qs, depth: int) -> bool:
        if depth > MAXIMUM_QUORUM_NESTING_LEVEL:
            return False
        if qs.threshold < 1:
            return False
        tot = len(qs.validators) + len(qs.innerSets)
        if qs.threshold > tot:
            return False
        vblocking_size = tot - qs.threshold + 1
        if extra_checks and qs.threshold < vblocking_size:
            return False
        count[0] += len(qs.validators)
        for v in qs.validators:
            k = v.value
            if k in seen:
                return False
            seen.add(k)
        return all(check(s, depth + 1) for s in qs.innerSets)

    if not check(qset, 0):
        return False
    return 1 <= count[0] <= MAX_NODES_IN_QSET


def normalize_qset(qset, id_to_remove: Optional[bytes] = None):
    """Returns a simplified copy: drop ``id_to_remove`` (threshold reduced by
    occurrences removed), promote singleton inner sets, collapse
    1-of-{single-inner} wrappers (ref normalizeQSetSimplify)."""

    def simplify(qs):
        validators = [v for v in qs.validators]
        threshold = qs.threshold
        if id_to_remove is not None:
            kept = [v for v in validators if v.value != id_to_remove]
            threshold -= len(validators) - len(kept)
            validators = kept
        inner = []
        for s in qs.innerSets:
            s2 = simplify(s)
            if (s2.threshold == 1 and len(s2.validators) == 1
                    and not s2.innerSets):
                validators.append(s2.validators[0])
            else:
                inner.append(s2)
        out = T.SCPQuorumSet.make(
            threshold=threshold, validators=validators, innerSets=inner)
        if out.threshold == 1 and not out.validators and len(
                out.innerSets) == 1:
            return out.innerSets[0]
        return out

    return simplify(qset)


def for_all_nodes(qset):
    """Yield every node id in the qset tree (may repeat if insane)."""
    for v in qset.validators:
        yield v.value
    for s in qset.innerSets:
        yield from for_all_nodes(s)


UINT64_MAX = 2**64 - 1


def get_node_weight(node_id: bytes, qset) -> int:
    """Leader-election weight: product of threshold fractions down the path
    to the node's first occurrence, scaled to 2^64-1 (ref
    LocalNode::getNodeWeight; ROUND_UP division)."""
    n = qset.threshold
    d = len(qset.innerSets) + len(qset.validators)
    for v in qset.validators:
        if v.value == node_id:
            return -(-UINT64_MAX * n // d)  # ceil division
    for s in qset.innerSets:
        leaf = get_node_weight(node_id, s)
        if leaf:
            return -(-leaf * n // d)
    return 0
