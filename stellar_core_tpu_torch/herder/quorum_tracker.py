"""QuorumTracker: the transitive quorum known to this node
(ref src/herder/QuorumTracker.h:26-76, QuorumTracker.cpp).

A tracked node is definitely in the local transitive quorum; its qset may
still be unknown (None) when another node lists it but we have not heard
its own quorum set yet.  Each node carries its BFS distance from the
local node and the set of local-qset validators closest to it — the
reference uses those to pick which validators to nag for missing info.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Set

from ..scp.local_node import qset_nodes


class NodeInfo:
    __slots__ = ("qset", "distance", "closest_validators")

    def __init__(self, qset=None, distance: int = 0,
                 closest_validators: Optional[Set[bytes]] = None):
        self.qset = qset
        self.distance = distance
        self.closest_validators = closest_validators or set()


class QuorumTracker:
    def __init__(self, local_node_id: bytes, local_qset):
        self.local_node_id = local_node_id
        self.quorum: Dict[bytes, NodeInfo] = {}
        self.rebuild(lambda _nid: None, local_qset)

    def is_node_definitely_in_quorum(self, node_id: bytes) -> bool:
        return node_id in self.quorum

    def expand(self, node_id: bytes, qset) -> bool:
        """Fill in / extend the quorum at ``node_id`` (ref
        QuorumTracker::expand).  Out-of-closure nodes are a successful
        no-op (the reference returns true there too — anything else
        would make every watcher envelope force a full rebuild); False
        means an INCONSISTENT announcement (a different qset is already
        recorded) and the caller should rebuild."""
        info = self.quorum.get(node_id)
        if info is None:
            return True  # not in the transitive quorum: nothing to do
        if info.qset is not None:
            return info.qset == qset  # re-announce must match
        info.qset = qset
        self._add_dependencies(node_id, info, qset)
        return True

    def _add_dependencies(self, node_id: bytes, info: NodeInfo,
                          qset) -> None:
        for dep in qset_nodes(qset):
            existing = self.quorum.get(dep)
            if dep == self.local_node_id:
                continue
            # closest validators propagate: local-qset members carry
            # themselves, deeper nodes inherit from their predecessor
            closest = ({dep} if info.distance == 0
                       else set(info.closest_validators))
            if existing is None:
                self.quorum[dep] = NodeInfo(
                    None, info.distance + 1, closest)
            elif existing.distance == info.distance + 1:
                existing.closest_validators |= closest

    def rebuild(self, lookup: Callable[[bytes], object],
                local_qset) -> None:
        """Recompute the closure from scratch via BFS, resolving qsets
        through ``lookup`` (ref QuorumTracker::rebuild)."""
        self.quorum = {self.local_node_id: NodeInfo(local_qset, 0)}
        frontier = [self.local_node_id]
        while frontier:
            nxt = []
            for nid in frontier:
                info = self.quorum[nid]
                if info.qset is None:
                    info.qset = lookup(nid)
                if info.qset is None:
                    continue
                before = set(self.quorum)
                self._add_dependencies(nid, info, info.qset)
                nxt.extend(set(self.quorum) - before)
            frontier = nxt

    def qset_map(self) -> Dict[bytes, object]:
        """node -> qset for every tracked node with a known qset — the
        quorum-intersection checker's input."""
        return {nid: info.qset for nid, info in self.quorum.items()
                if info.qset is not None}

    def nodes_missing_qsets(self) -> Set[bytes]:
        return {nid for nid, info in self.quorum.items()
                if info.qset is None}
