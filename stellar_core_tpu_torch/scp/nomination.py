"""NominationProtocol: leader-based value nomination
(ref src/scp/NominationProtocol.cpp; whitepaper section on nomination).

State: X (votes), Y (accepted), Z (candidates), round leaders.  Each round,
a deterministic weighted hash over the (normalized, self-excluded) local
qset picks leaders; non-leaders echo leader votes.  Values promote
votes -> accepted via federated accept, accepted -> candidates via ratify;
the first candidates trigger the ballot protocol with the driver's
combined composite value.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..xdr import types as T
from . import statement as S
from .driver import NOMINATION_TIMER, ValidationLevel
from .quorum_sanity import for_all_nodes, get_node_weight, normalize_qset
from .statement import node_of

UINT64_MAX = 2**64 - 1


class NominationProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.round_number = 0
        self.votes: Set[bytes] = set()       # X
        self.accepted: Set[bytes] = set()    # Y
        self.candidates: Set[bytes] = set()  # Z
        self.latest_nominations: Dict[bytes, object] = {}
        self.last_envelope = None            # last self nomination sent
        self.last_envelope_emit = None
        self.round_leaders: Set[bytes] = set()
        self.started = False
        self.previous_value = b""
        self.latest_composite: Optional[bytes] = None
        self.timer_exp_count = 0

    @property
    def driver(self):
        return self.slot.driver

    @property
    def local_node(self):
        return self.slot.local_node

    # -- predicates --------------------------------------------------------

    def _is_newer(self, node_id: bytes, nom) -> bool:
        old = self.latest_nominations.get(node_id)
        if old is None:
            return True
        return S.is_newer_nomination(old.statement.pledges.value, nom)

    def _validate_value(self, v: bytes) -> ValidationLevel:
        return self.driver.validate_value(self.slot.slot_index, v, True)

    def _accept_predicate(self, v: bytes, st) -> bool:
        return v in st.pledges.value.accepted

    def _vote_predicate(self, v: bytes, st) -> bool:
        return v in st.pledges.value.votes

    # -- leader election ---------------------------------------------------

    def _hash_node(self, is_priority: bool, node_id: bytes) -> int:
        return self.driver.compute_hash_node(
            self.slot.slot_index, self.previous_value, is_priority,
            self.round_number, node_id)

    def _hash_value(self, value: bytes) -> int:
        return self.driver.compute_value_hash(
            self.slot.slot_index, self.previous_value, self.round_number,
            value)

    def _node_priority(self, node_id: bytes, qset) -> int:
        if node_id == self.local_node.node_id:
            w = UINT64_MAX  # local node is in all quorum sets
        else:
            w = get_node_weight(node_id, qset)
        if w > 0 and self._hash_node(False, node_id) <= w:
            return self._hash_node(True, node_id)
        return 0

    def _update_round_leaders(self) -> None:
        my_qset = normalize_qset(
            self.local_node.qset, id_to_remove=self.local_node.node_id)
        local_id = self.local_node.node_id
        nodes = list(dict.fromkeys(for_all_nodes(my_qset)))
        max_leader_count = 1 + len(nodes)

        while len(self.round_leaders) < max_leader_count:
            new_leaders = {local_id}
            top = self._node_priority(local_id, my_qset)
            for cur in nodes:
                w = self._node_priority(cur, my_qset)
                if w > top:
                    top = w
                    new_leaders = set()
                if w == top and w > 0:
                    new_leaders.add(cur)
            before = len(self.round_leaders)
            self.round_leaders |= new_leaders
            if len(self.round_leaders) != before:
                return
            self.round_number += 1  # fast-forward a no-op round

    # -- value picking -----------------------------------------------------

    def _get_new_value_from_nomination(self, nom) -> Optional[bytes]:
        """Highest-value-hash valid value from a leader's nomination we
        don't already vote for (accepted preferred over votes)."""
        new_vote: Optional[bytes] = None
        new_hash = 0
        found_valid = False

        def pick(value: bytes):
            nonlocal new_vote, new_hash, found_valid
            lvl = self._validate_value(value)
            if lvl >= ValidationLevel.FULLY_VALIDATED:
                candidate = value
            else:
                candidate = self.driver.extract_valid_value(
                    self.slot.slot_index, value)
            if candidate is not None:
                found_valid = True
                if candidate not in self.votes:
                    h = self._hash_value(candidate)
                    if h >= new_hash:
                        new_hash = h
                        new_vote = candidate

        for v in nom.accepted:
            pick(v)
        if not found_valid:
            for v in nom.votes:
                pick(v)
        return new_vote

    # -- envelope processing -----------------------------------------------

    def process_envelope(self, envelope):
        from ..utils.tracing import tracer_of
        from .slot import EnvelopeState

        with tracer_of(self.driver).span("scp.nominate.envelope",
                                         slot=self.slot.slot_index):
            return self._process_envelope(envelope, EnvelopeState)

    def _process_envelope(self, envelope, EnvelopeState):
        st = envelope.statement
        nom = st.pledges.value
        if not self._is_newer(node_of(st), nom):
            return EnvelopeState.INVALID
        if not S.is_nomination_sane(st):
            return EnvelopeState.INVALID
        self.latest_nominations[node_of(st)] = envelope

        if not self.started:
            return EnvelopeState.VALID

        modified = False
        new_candidates = False
        tl = self.slot.scp.timeline

        # votes -> accepted
        for v in nom.votes:
            if v in self.accepted:
                continue
            if self.slot.federated_accept(
                lambda s, vv=v: self._vote_predicate(vv, s),
                lambda s, vv=v: self._accept_predicate(vv, s),
                self.latest_nominations,
            ):
                lvl = self._validate_value(v)
                if lvl >= ValidationLevel.FULLY_VALIDATED:
                    self.accepted.add(v)
                    self.votes.add(v)
                    modified = True
                    if tl.enabled:
                        from .timeline import value_tag

                        tl.record(self.slot.slot_index, "nom.accept",
                                  {"v": value_tag(v)})
                else:
                    to_vote = self.driver.extract_valid_value(
                        self.slot.slot_index, v)
                    if to_vote is not None and to_vote not in self.votes:
                        self.votes.add(to_vote)
                        modified = True

        # accepted -> candidates (sorted: set iteration order must not
        # leak into protocol behavior — detlint det-unsorted-iter)
        for a in sorted(self.accepted):
            if a in self.candidates:
                continue
            if self.slot.federated_ratify(
                lambda s, aa=a: self._accept_predicate(aa, s),
                self.latest_nominations,
            ):
                self.candidates.add(a)
                new_candidates = True
                if tl.enabled:
                    from .timeline import value_tag

                    tl.record(self.slot.slot_index, "nom.candidate",
                              {"v": value_tag(a)})
                # whitepaper: stop nominating new values once a candidate
                # exists
                self.driver.setup_timer(
                    self.slot.slot_index, NOMINATION_TIMER, 0.0, None)

        # echo round-leader votes while still looking for candidates
        if not self.candidates and node_of(st) in self.round_leaders:
            new_vote = self._get_new_value_from_nomination(nom)
            if new_vote is not None:
                self.votes.add(new_vote)
                modified = True
                if tl.enabled:
                    from .timeline import value_tag

                    tl.record(self.slot.slot_index, "nom.vote",
                              {"v": value_tag(new_vote), "echo": True})
                self.driver.nominating_value(
                    self.slot.slot_index, new_vote)

        if modified:
            self._emit_nomination()

        if new_candidates:
            composite = self.driver.combine_candidates(
                self.slot.slot_index, set(self.candidates))
            if composite is not None:
                self.latest_composite = composite
                if tl.enabled:
                    from .timeline import value_tag

                    tl.record(self.slot.slot_index, "nom.composite",
                              {"v": value_tag(composite),
                               "candidates": len(self.candidates)})
                self.driver.updated_candidate_value(
                    self.slot.slot_index, composite)
                self.slot.bump_state(composite, False)

        return EnvelopeState.VALID

    # -- nomination rounds -------------------------------------------------

    def nominate(self, value: bytes, previous_value: bytes,
                 timedout: bool) -> bool:
        from ..utils.tracing import tracer_of

        with tracer_of(self.driver).span(
                "scp.nominate.round", slot=self.slot.slot_index,
                round=self.round_number + 1, timedout=timedout):
            return self._nominate(value, previous_value, timedout)

    def _nominate(self, value: bytes, previous_value: bytes,
                  timedout: bool) -> bool:
        if self.candidates:
            return False  # already have a candidate; stop proposing
        if timedout:
            self.timer_exp_count += 1
            if not self.started:
                return False
        self.started = True
        self.previous_value = previous_value
        self.round_number += 1
        self._update_round_leaders()
        tl = self.slot.scp.timeline
        if tl.enabled:
            tl.record(self.slot.slot_index, "nom.round",
                      {"round": self.round_number, "timedout": timedout,
                       "leaders": len(self.round_leaders),
                       "self_leader": self.local_node.node_id
                       in self.round_leaders})

        updated = False
        # add a few more values from the leaders' nominations.  Sorted:
        # _get_new_value_from_nomination skips values already in
        # self.votes, so the pick is loop-carried — iterating the
        # round_leaders SET in hash order made the voted values depend
        # on PYTHONHASHSEED (a P0 detlint finding)
        for leader in sorted(self.round_leaders):
            env = self.latest_nominations.get(leader)
            if env is not None:
                v = self._get_new_value_from_nomination(
                    env.statement.pledges.value)
                if v is not None:
                    self.votes.add(v)
                    updated = True
                    if tl.enabled:
                        from .timeline import value_tag

                        tl.record(self.slot.slot_index, "nom.vote",
                                  {"v": value_tag(v),
                                   "leader": leader.hex()[:8]})
                    self.driver.nominating_value(self.slot.slot_index, v)
        # if we're a leader, seed our own value
        if self.local_node.node_id in self.round_leaders and not self.votes:
            if value not in self.votes:
                self.votes.add(value)
                updated = True
                if tl.enabled:
                    from .timeline import value_tag

                    tl.record(self.slot.slot_index, "nom.vote",
                              {"v": value_tag(value), "own": True})
                self.driver.nominating_value(self.slot.slot_index, value)

        timeout = self.driver.compute_timeout(self.round_number, True)
        self.driver.setup_timer(
            self.slot.slot_index, NOMINATION_TIMER, timeout,
            lambda: self.slot.nominate(value, previous_value, True))

        if updated:
            self._emit_nomination()
        return updated

    def stop_nomination(self) -> None:
        self.started = False

    # -- emission ----------------------------------------------------------

    def _emit_nomination(self) -> None:
        from .slot import EnvelopeState

        pledges = T.SCPStatementPledges.make(
            S.ST_NOMINATE,
            T.SCPNomination.make(
                quorumSetHash=self.local_node.qset_hash,
                votes=sorted(self.votes),
                accepted=sorted(self.accepted),
            ),
        )
        env = self.slot.create_envelope(pledges)
        st = env.statement
        if self._is_newer(self.local_node.node_id, st.pledges.value):
            if self.slot.process_envelope(env, self_=True) == \
                    EnvelopeState.VALID:
                if self.last_envelope is None or S.is_newer_nomination(
                    self.last_envelope.statement.pledges.value,
                    st.pledges.value,
                ):
                    self.last_envelope = env
                    if self.slot.fully_validated:
                        self.last_envelope_emit = env
                        tl = self.slot.scp.timeline
                        if tl.enabled:
                            tl.record(self.slot.slot_index, "nom.emit",
                                      {"votes": len(self.votes),
                                       "accepted": len(self.accepted)})
                        self.driver.emit_envelope(env)
            else:
                raise RuntimeError(
                    "moved to a bad state (nomination protocol)")

    # -- introspection -----------------------------------------------------

    def get_json_info(self) -> dict:
        return {
            "roundnumber": self.round_number,
            "started": self.started,
            "X": sorted(self.votes),
            "Y": sorted(self.accepted),
            "Z": sorted(self.candidates),
        }

    def get_latest_message(self, node_id: bytes):
        return self.latest_nominations.get(node_id)
