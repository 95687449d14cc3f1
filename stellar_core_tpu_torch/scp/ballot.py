"""BallotProtocol: the prepare/confirm/externalize state machine — the core
of federated Byzantine agreement (ref src/scp/BallotProtocol.cpp; whitepaper
steps 1-9).

State: b (current ballot), p >= p' (two highest accepted-prepared,
incompatible), c..h (commit interval), phase, latest statement per node.
Every inbound statement triggers ``advance_slot``: a fixed sequence of
attempt* steps, each a federated-voting tally over the latest statements.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Set, Tuple

from ..xdr import types as T
from . import local_node as LN
from . import statement as S
from .driver import BALLOT_TIMER, ValidationLevel
from .statement import (
    Ballot, UINT32_MAX, ballot_from_xdr, ballot_to_xdr, compatible,
    less_and_compatible, less_and_incompatible, node_of, pledge_type,
)

MAX_ADVANCE_SLOT_RECURSION = 50


class Phase(IntEnum):
    PREPARE = 0
    CONFIRM = 1
    EXTERNALIZE = 2


class BallotProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.phase = Phase.PREPARE
        self.current: Optional[Ballot] = None        # b
        self.prepared: Optional[Ballot] = None       # p
        self.prepared_prime: Optional[Ballot] = None  # p'
        self.high: Optional[Ballot] = None           # h
        self.commit: Optional[Ballot] = None         # c
        self.latest_envelopes: Dict[bytes, object] = {}
        self.value_override: Optional[bytes] = None
        self.heard_from_quorum = False
        self.message_level = 0
        self.last_envelope = None
        self.last_envelope_emit = None
        self.timer_exp_count = 0

    # -- driver-ish accessors ---------------------------------------------

    @property
    def driver(self):
        return self.slot.driver

    @property
    def local_node(self):
        return self.slot.local_node

    # -- envelope processing ----------------------------------------------

    def process_envelope(self, envelope, self_: bool = False):
        from ..utils.tracing import tracer_of
        from .slot import EnvelopeState

        with tracer_of(self.driver).span("scp.ballot.envelope",
                                         slot=self.slot.slot_index):
            return self._process_envelope(envelope, self_, EnvelopeState)

    def _process_envelope(self, envelope, self_, EnvelopeState):
        st = envelope.statement
        if not self._statement_sane(st, self_):
            return EnvelopeState.INVALID
        if not self._is_newer(node_of(st), st):
            return EnvelopeState.INVALID
        lvl = self._validate_values(st)
        if lvl == ValidationLevel.INVALID:
            return EnvelopeState.INVALID

        if self.phase != Phase.EXTERNALIZE:
            if lvl == ValidationLevel.MAYBE_VALID:
                self.slot.set_fully_validated(False)
            self.latest_envelopes[node_of(st)] = envelope
            self.advance_slot(st)
            return EnvelopeState.VALID

        # already externalized: only absorb compatible statements
        if self.commit is not None and self.commit[1] == S.working_ballot(
                st)[1]:
            self.latest_envelopes[node_of(st)] = envelope
            return EnvelopeState.VALID
        return EnvelopeState.INVALID

    def _statement_sane(self, st, self_: bool) -> bool:
        qset = self.slot.qset_from_statement(st)
        if qset is None:
            return False
        from .quorum_sanity import is_quorum_set_sane

        if not is_quorum_set_sane(qset, extra_checks=False):
            return False
        return S.is_ballot_sane(st, self_)

    def _is_newer(self, node_id: bytes, st) -> bool:
        old = self.latest_envelopes.get(node_id)
        if old is None:
            return True
        return S.is_newer_ballot_statement(old.statement, st)

    def _validate_values(self, st) -> ValidationLevel:
        values = S.ballot_statement_values(st)
        if not values:
            return ValidationLevel.INVALID
        lvl = ValidationLevel.FULLY_VALIDATED
        for v in values:
            if lvl == ValidationLevel.INVALID:
                break
            tr = self.driver.validate_value(self.slot.slot_index, v, False)
            lvl = min(tr, lvl)
        return lvl

    # -- external triggers -------------------------------------------------

    def bump_state(self, value: bytes, force_or_n) -> bool:
        from ..utils.tracing import tracer_of

        with tracer_of(self.driver).span("scp.ballot.bump",
                                         slot=self.slot.slot_index):
            return self._bump_state(value, force_or_n)

    def _bump_state(self, value: bytes, force_or_n) -> bool:
        if isinstance(force_or_n, bool):
            if not force_or_n and self.current is not None:
                return False
            n = self.current[0] + 1 if self.current is not None else 1
        else:
            n = force_or_n
        return self._bump_state_n(value, n)

    def _bump_state_n(self, value: bytes, n: int) -> bool:
        if self.phase not in (Phase.PREPARE, Phase.CONFIRM):
            return False
        newb: Ballot = (
            n, self.value_override if self.value_override is not None
            else value)
        updated = self._update_current_value(newb)
        if updated:
            self._emit_current_state()
            self._check_heard_from_quorum()
        return updated

    def abandon_ballot(self, n: int) -> bool:
        v = self.slot.get_latest_composite_candidate()
        if not v:
            if self.current is not None:
                v = self.current[1]
        if not v:
            return False
        if n == 0:
            return self.bump_state(v, True)
        return self._bump_state_n(v, n)

    def ballot_timer_expired(self) -> None:
        self.timer_exp_count += 1
        tl = self.slot.scp.timeline
        if tl.enabled:
            tl.record(self.slot.slot_index, "timer.fire",
                      {"timer": "ballot", "count": self.timer_exp_count})
        self.abandon_ballot(0)

    def set_state_from_envelope(self, envelope) -> None:
        """Restore this node's OWN ballot state from a persisted envelope
        (ref BallotProtocol::setStateFromEnvelope) — the restart-from-
        state path.  Without this a restarted validator records its
        pre-crash statement but runs the protocol from scratch, and its
        first fresh emission is older than its own recorded statement —
        the self-process then refuses it and the node crashes ("moved to
        a bad state"), which the chaos kill-restore scenario exposed.

        Only legal before the protocol started; ignored (like the
        reference's throw, minus the crash) otherwise."""
        if self.current is not None:
            return
        st = envelope.statement
        t = pledge_type(st)
        p = st.pledges.value
        if t == S.ST_PREPARE:
            b = ballot_from_xdr(p.ballot)
            self._bump_to_ballot(b, True)
            if p.prepared is not None:
                self.prepared = ballot_from_xdr(p.prepared)
            if p.preparedPrime is not None:
                self.prepared_prime = ballot_from_xdr(p.preparedPrime)
            if p.nH:
                self.high = (p.nH, b[1])
            if p.nC:
                self.commit = (p.nC, b[1])
            self.phase = Phase.PREPARE
        elif t == S.ST_CONFIRM:
            b = ballot_from_xdr(p.ballot)
            v = b[1]
            self._bump_to_ballot(b, True)
            self.prepared = (p.nPrepared, v)
            self.high = (p.nH, v)
            self.commit = (p.nCommit, v)
            self.phase = Phase.CONFIRM
        elif t == S.ST_EXTERNALIZE:
            cb = ballot_from_xdr(p.commit)
            v = cb[1]
            self._bump_to_ballot((UINT32_MAX, v), True)
            self.prepared = (UINT32_MAX, v)
            self.high = (p.nH, v)
            self.commit = cb
            self.phase = Phase.EXTERNALIZE
        else:
            return
        self.latest_envelopes[node_of(st)] = envelope
        self.last_envelope = envelope
        self.last_envelope_emit = envelope

    # -- state maintenance -------------------------------------------------

    def _update_current_value(self, ballot: Ballot) -> bool:
        if self.phase not in (Phase.PREPARE, Phase.CONFIRM):
            return False
        if self.current is None:
            self._bump_to_ballot(ballot, True)
            return True
        if self.commit is not None and not compatible(self.commit, ballot):
            return False
        if self.current < ballot:
            self._bump_to_ballot(ballot, True)
            return True
        if self.current > ballot:
            return False
        self._check_invariants()
        return False

    def _bump_to_ballot(self, ballot: Ballot, check: bool) -> None:
        assert self.phase != Phase.EXTERNALIZE
        if check:
            assert self.current is None or ballot >= self.current
        got_bumped = self.current is None or self.current[0] != ballot[0]
        if self.current is None:
            self.driver.started_ballot_protocol(
                self.slot.slot_index, ballot)
        tl = self.slot.scp.timeline
        if tl.enabled and (got_bumped or self.current is None
                           or self.current != ballot):
            from .timeline import value_tag

            tl.record(self.slot.slot_index, "ballot.bump",
                      {"n": ballot[0], "v": value_tag(ballot[1])})
        self.current = ballot
        # invariant: h compatible with b
        if self.high is not None and not compatible(self.current, self.high):
            self.high = None
            self.commit = None
        if got_bumped:
            self.heard_from_quorum = False

    def _check_invariants(self) -> None:
        if self.current is not None:
            assert self.current[0] != 0
        if self.phase in (Phase.CONFIRM, Phase.EXTERNALIZE):
            assert self.current is not None
            assert self.prepared is not None
            assert self.commit is not None
            assert self.high is not None
        if self.prepared is not None and self.prepared_prime is not None:
            assert less_and_incompatible(self.prepared_prime, self.prepared)
        if self.high is not None:
            assert self.current is not None
            assert less_and_compatible(self.high, self.current)
        if self.commit is not None:
            assert self.high is not None
            assert less_and_compatible(self.commit, self.high)
            assert less_and_compatible(self.high, self.current)

    # -- statement emission ------------------------------------------------

    def _create_statement_pledges(self):
        qh = self.local_node.qset_hash
        if self.phase == Phase.PREPARE:
            p = T.SCPStatementPledges.make(
                S.ST_PREPARE,
                T.SCPStatementPledges.arms[S.ST_PREPARE][1].make(
                    quorumSetHash=qh,
                    ballot=ballot_to_xdr(self.current)
                    if self.current is not None else ballot_to_xdr((0, b"")),
                    prepared=ballot_to_xdr(self.prepared)
                    if self.prepared is not None else None,
                    preparedPrime=ballot_to_xdr(self.prepared_prime)
                    if self.prepared_prime is not None else None,
                    nC=self.commit[0] if self.commit is not None else 0,
                    nH=self.high[0] if self.high is not None else 0,
                ),
            )
        elif self.phase == Phase.CONFIRM:
            p = T.SCPStatementPledges.make(
                S.ST_CONFIRM,
                T.SCPStatementPledges.arms[S.ST_CONFIRM][1].make(
                    ballot=ballot_to_xdr(self.current),
                    nPrepared=self.prepared[0],
                    nCommit=self.commit[0],
                    nH=self.high[0],
                    quorumSetHash=qh,
                ),
            )
        else:
            p = T.SCPStatementPledges.make(
                S.ST_EXTERNALIZE,
                T.SCPStatementPledges.arms[S.ST_EXTERNALIZE][1].make(
                    commit=ballot_to_xdr(self.commit),
                    nH=self.high[0],
                    commitQuorumSetHash=qh,
                ),
            )
        return p

    def _emit_current_state(self) -> None:
        from .slot import EnvelopeState

        self._check_invariants()
        env = self.slot.create_envelope(self._create_statement_pledges())
        can_emit = self.current is not None

        last = self.latest_envelopes.get(self.local_node.node_id)
        if last is not None and T.SCPEnvelope.encode(last) == \
                T.SCPEnvelope.encode(env):
            return
        if self.slot.process_envelope(env, self_=True) == \
                EnvelopeState.VALID:
            if can_emit and (
                self.last_envelope is None
                or S.is_newer_ballot_statement(
                    self.last_envelope.statement, env.statement)
            ):
                self.last_envelope = env
                self._send_latest_envelope()
        else:
            raise RuntimeError("moved to a bad state (ballot protocol)")

    def _send_latest_envelope(self) -> None:
        if (self.message_level == 0 and self.last_envelope is not None
                and self.slot.fully_validated):
            if self.last_envelope_emit is not self.last_envelope:
                self.last_envelope_emit = self.last_envelope
                tl = self.slot.scp.timeline
                if tl.enabled:
                    from .timeline import statement_fingerprint

                    tl.record(self.slot.slot_index, "ballot.emit",
                              {"fp": statement_fingerprint(
                                  self.last_envelope_emit.statement),
                               "phase": self.phase.name})
                self.driver.emit_envelope(self.last_envelope_emit)

    # -- the whitepaper steps ---------------------------------------------

    def advance_slot(self, hint_st) -> None:
        self.message_level += 1
        if self.message_level >= MAX_ADVANCE_SLOT_RECURSION:
            raise RuntimeError("maximum advanceSlot recursion")
        did_work = False
        did_work = self._attempt_accept_prepared(hint_st) or did_work
        did_work = self._attempt_confirm_prepared(hint_st) or did_work
        did_work = self._attempt_accept_commit(hint_st) or did_work
        did_work = self._attempt_confirm_commit(hint_st) or did_work
        if self.message_level == 1:
            did_bump = True
            while did_bump:
                did_bump = self._attempt_bump()
                did_work = did_bump or did_work
            self._check_heard_from_quorum()
        self.message_level -= 1
        if did_work:
            self._send_latest_envelope()

    # step 1-2: accept prepared
    def _get_prepare_candidates(self, hint) -> List[Ballot]:
        t = pledge_type(hint)
        p = hint.pledges.value
        hint_ballots: Set[Ballot] = set()
        if t == S.ST_PREPARE:
            hint_ballots.add(ballot_from_xdr(p.ballot))
            if p.prepared is not None:
                hint_ballots.add(ballot_from_xdr(p.prepared))
            if p.preparedPrime is not None:
                hint_ballots.add(ballot_from_xdr(p.preparedPrime))
        elif t == S.ST_CONFIRM:
            hint_ballots.add((p.nPrepared, p.ballot.value))
            hint_ballots.add((UINT32_MAX, p.ballot.value))
        elif t == S.ST_EXTERNALIZE:
            hint_ballots.add((UINT32_MAX, p.commit.value))

        candidates: Set[Ballot] = set()
        for top_vote in sorted(hint_ballots, reverse=True):
            val = top_vote[1]
            for _, env in sorted(self.latest_envelopes.items()):
                st = env.statement
                t2 = pledge_type(st)
                p2 = st.pledges.value
                if t2 == S.ST_PREPARE:
                    b = ballot_from_xdr(p2.ballot)
                    if less_and_compatible(b, top_vote):
                        candidates.add(b)
                    if p2.prepared is not None:
                        pb = ballot_from_xdr(p2.prepared)
                        if less_and_compatible(pb, top_vote):
                            candidates.add(pb)
                    if p2.preparedPrime is not None:
                        ppb = ballot_from_xdr(p2.preparedPrime)
                        if less_and_compatible(ppb, top_vote):
                            candidates.add(ppb)
                elif t2 == S.ST_CONFIRM:
                    cb = ballot_from_xdr(p2.ballot)
                    if compatible(top_vote, cb):
                        candidates.add(top_vote)
                        if p2.nPrepared < top_vote[0]:
                            candidates.add((p2.nPrepared, val))
                elif t2 == S.ST_EXTERNALIZE:
                    eb = ballot_from_xdr(p2.commit)
                    if compatible(top_vote, eb):
                        candidates.add(top_vote)
        return sorted(candidates, reverse=True)

    def _attempt_accept_prepared(self, hint) -> bool:
        if self.phase not in (Phase.PREPARE, Phase.CONFIRM):
            return False
        for ballot in self._get_prepare_candidates(hint):
            if self.phase == Phase.CONFIRM:
                if not less_and_compatible(self.prepared, ballot):
                    continue
                assert compatible(self.commit, ballot)
            if (self.prepared_prime is not None
                    and ballot <= self.prepared_prime):
                continue
            if (self.prepared is not None
                    and less_and_compatible(ballot, self.prepared)):
                continue
            accepted = self.slot.federated_accept(
                lambda st, b=ballot: S.votes_prepare(b, st),
                lambda st, b=ballot: S.hasprepared_ballot(b, st),
                self.latest_envelopes,
            )
            if accepted:
                return self._set_accept_prepared(ballot)
        return False

    def _set_accept_prepared(self, ballot: Ballot) -> bool:
        did_work = self._set_prepared(ballot)
        if self.commit is not None and self.high is not None:
            if ((self.prepared is not None
                 and less_and_incompatible(self.high, self.prepared))
                    or (self.prepared_prime is not None
                        and less_and_incompatible(
                            self.high, self.prepared_prime))):
                assert self.phase == Phase.PREPARE
                self.commit = None
                did_work = True
        if did_work:
            tl = self.slot.scp.timeline
            if tl.enabled:
                from .timeline import value_tag

                tl.record(self.slot.slot_index, "ballot.accept_prepared",
                          {"n": ballot[0], "v": value_tag(ballot[1])})
            self.driver.accepted_ballot_prepared(
                self.slot.slot_index, ballot)
            self._emit_current_state()
        return did_work

    def _set_prepared(self, ballot: Ballot) -> bool:
        did_work = False
        if self.prepared is not None:
            if self.prepared < ballot:
                if not compatible(self.prepared, ballot):
                    self.prepared_prime = self.prepared
                self.prepared = ballot
                did_work = True
            elif self.prepared > ballot:
                if self.prepared_prime is None or (
                        self.prepared_prime < ballot
                        and not compatible(self.prepared, ballot)):
                    self.prepared_prime = ballot
                    did_work = True
        else:
            self.prepared = ballot
            did_work = True
        return did_work

    # step 3-4: confirm prepared
    def _attempt_confirm_prepared(self, hint) -> bool:
        if self.phase != Phase.PREPARE:
            return False
        if self.prepared is None:
            return False
        candidates = self._get_prepare_candidates(hint)
        new_h = None
        idx = 0
        for i, ballot in enumerate(candidates):
            if self.high is not None and self.high >= ballot:
                break
            if self.slot.federated_ratify(
                lambda st, b=ballot: S.hasprepared_ballot(b, st),
                self.latest_envelopes,
            ):
                new_h = ballot
                idx = i
                break
        if new_h is None:
            return False

        new_c: Optional[Ballot] = None
        b = self.current if self.current is not None else (0, b"")
        if (self.commit is None
                and (self.prepared is None
                     or not less_and_incompatible(new_h, self.prepared))
                and (self.prepared_prime is None
                     or not less_and_incompatible(
                         new_h, self.prepared_prime))):
            for ballot in candidates[idx:]:
                if ballot < b:
                    break
                if not less_and_compatible(ballot, new_h):
                    continue
                if self.slot.federated_ratify(
                    lambda st, bb=ballot: S.hasprepared_ballot(bb, st),
                    self.latest_envelopes,
                ):
                    new_c = ballot
                else:
                    break
        return self._set_confirm_prepared(new_c, new_h)

    def _set_confirm_prepared(self, new_c: Optional[Ballot],
                              new_h: Ballot) -> bool:
        did_work = False
        self.value_override = new_h[1]
        if self.current is None or compatible(self.current, new_h):
            if self.high is None or new_h > self.high:
                did_work = True
                self.high = new_h
            if new_c is not None:
                assert self.commit is None
                self.commit = new_c
                did_work = True
            if did_work:
                tl = self.slot.scp.timeline
                if tl.enabled:
                    from .timeline import value_tag

                    tl.record(self.slot.slot_index,
                              "ballot.confirm_prepared",
                              {"h": [new_h[0], value_tag(new_h[1])],
                               "c": None if new_c is None else
                               [new_c[0], value_tag(new_c[1])]})
                self.driver.confirmed_ballot_prepared(
                    self.slot.slot_index, new_h)
        did_work = self._update_current_if_needed(new_h) or did_work
        if did_work:
            self._emit_current_state()
        return did_work

    def _update_current_if_needed(self, h: Ballot) -> bool:
        if self.current is None or self.current < h:
            self._bump_to_ballot(h, True)
            return True
        return False

    # step 5-6: accept commit
    def _get_commit_boundaries(self, ballot: Ballot) -> List[int]:
        res: Set[int] = set()
        for _, env in sorted(self.latest_envelopes.items()):
            st = env.statement
            t = pledge_type(st)
            p = st.pledges.value
            if t == S.ST_PREPARE:
                if compatible(ballot, ballot_from_xdr(p.ballot)) and p.nC:
                    res.add(p.nC)
                    res.add(p.nH)
            elif t == S.ST_CONFIRM:
                if compatible(ballot, ballot_from_xdr(p.ballot)):
                    res.add(p.nCommit)
                    res.add(p.nH)
            elif t == S.ST_EXTERNALIZE:
                if compatible(ballot, ballot_from_xdr(p.commit)):
                    res.add(p.commit.counter)
                    res.add(p.nH)
                    res.add(UINT32_MAX)
        return sorted(res)

    def _find_extended_interval(self, boundaries: List[int],
                                pred) -> Tuple[int, int]:
        candidate = (0, 0)
        for b in reversed(boundaries):
            if candidate[0] == 0:
                cur = (b, b)
            elif b > candidate[1]:
                continue
            else:
                cur = (b, candidate[1])
            if pred(cur):
                candidate = cur
            elif candidate[0] != 0:
                break
        return candidate

    def _attempt_accept_commit(self, hint) -> bool:
        if self.phase not in (Phase.PREPARE, Phase.CONFIRM):
            return False
        t = pledge_type(hint)
        p = hint.pledges.value
        if t == S.ST_PREPARE:
            if p.nC == 0:
                return False
            ballot = (p.nH, p.ballot.value)
        elif t == S.ST_CONFIRM:
            ballot = (p.nH, p.ballot.value)
        elif t == S.ST_EXTERNALIZE:
            ballot = (p.nH, p.commit.value)
        else:
            return False

        if self.phase == Phase.CONFIRM and not compatible(
                ballot, self.high):
            return False

        def pred(interval) -> bool:
            return self.slot.federated_accept(
                lambda st, b=ballot, iv=interval: S.votes_commit(b, iv, st),
                lambda st, b=ballot, iv=interval: S.commit_predicate(
                    b, iv, st),
                self.latest_envelopes,
            )

        boundaries = self._get_commit_boundaries(ballot)
        if not boundaries:
            return False
        candidate = self._find_extended_interval(boundaries, pred)
        if candidate[0] != 0:
            if (self.phase != Phase.CONFIRM
                    or candidate[1] > self.high[0]):
                c = (candidate[0], ballot[1])
                h = (candidate[1], ballot[1])
                return self._set_accept_commit(c, h)
        return False

    def _set_accept_commit(self, c: Ballot, h: Ballot) -> bool:
        did_work = False
        self.value_override = h[1]
        if self.high != h or self.commit != c:
            self.commit = c
            self.high = h
            did_work = True
        if self.phase == Phase.PREPARE:
            self.phase = Phase.CONFIRM
            if self.current is not None and not less_and_compatible(
                    h, self.current):
                self._bump_to_ballot(h, False)
            self.prepared_prime = None
            did_work = True
        if did_work:
            self._update_current_if_needed(self.high)
            tl = self.slot.scp.timeline
            if tl.enabled:
                from .timeline import value_tag

                tl.record(self.slot.slot_index, "ballot.accept_commit",
                          {"c": [c[0], value_tag(c[1])],
                           "h": [h[0], value_tag(h[1])],
                           "phase": self.phase.name})
            self.driver.accepted_commit(self.slot.slot_index, h)
            self._emit_current_state()
        return did_work

    # step 7: confirm commit -> externalize
    def _attempt_confirm_commit(self, hint) -> bool:
        if self.phase != Phase.CONFIRM:
            return False
        if self.high is None or self.commit is None:
            return False
        t = pledge_type(hint)
        p = hint.pledges.value
        if t == S.ST_PREPARE:
            return False
        if t == S.ST_CONFIRM:
            ballot = (p.nH, p.ballot.value)
        elif t == S.ST_EXTERNALIZE:
            ballot = (p.nH, p.commit.value)
        else:
            return False
        if not compatible(ballot, self.commit):
            return False

        boundaries = self._get_commit_boundaries(ballot)

        def pred(interval) -> bool:
            return self.slot.federated_ratify(
                lambda st, b=ballot, iv=interval: S.commit_predicate(
                    b, iv, st),
                self.latest_envelopes,
            )

        candidate = self._find_extended_interval(boundaries, pred)
        if candidate[0] == 0:
            return False
        c = (candidate[0], ballot[1])
        h = (candidate[1], ballot[1])
        return self._set_confirm_commit(c, h)

    def _set_confirm_commit(self, c: Ballot, h: Ballot) -> bool:
        self.commit = c
        self.high = h
        self._update_current_if_needed(self.high)
        self.phase = Phase.EXTERNALIZE
        tl = self.slot.scp.timeline
        if tl.enabled:
            from .timeline import value_tag

            tl.record(self.slot.slot_index, "ballot.externalize",
                      {"c": [c[0], value_tag(c[1])],
                       "h": [h[0], value_tag(h[1])]})
        self._emit_current_state()
        self.slot.stop_nomination()
        self.driver.value_externalized(self.slot.slot_index, self.commit[1])
        return True

    # step 9: bump to v-blocking-ahead counter
    def _attempt_bump(self) -> bool:
        if self.phase not in (Phase.PREPARE, Phase.CONFIRM):
            return False
        local_counter = self.current[0] if self.current is not None else 0

        def has_vblocking_ahead(n: int) -> bool:
            ahead = {
                node for node, env in self.latest_envelopes.items()
                if S.statement_ballot_counter(env.statement) > n
            }
            return LN.is_v_blocking(self.local_node.qset, ahead)

        if not has_vblocking_ahead(local_counter):
            return False
        all_counters = sorted({
            S.statement_ballot_counter(env.statement)
            for env in self.latest_envelopes.values()
            if S.statement_ballot_counter(env.statement) > local_counter
        })
        for n in all_counters:
            if not has_vblocking_ahead(n):
                return self.abandon_ballot(n)
        return False

    # -- quorum liveness ---------------------------------------------------

    def _check_heard_from_quorum(self) -> None:
        if self.current is None:
            return

        def pred(st) -> bool:
            if pledge_type(st) == S.ST_PREPARE:
                return (self.current[0]
                        <= st.pledges.value.ballot.counter)
            return True

        nodes = {
            n for n, env in self.latest_envelopes.items()
            if pred(env.statement)
        }

        def get_qset(node_id: bytes):
            env = self.latest_envelopes.get(node_id)
            if env is None:
                return None
            return self.slot.qset_from_statement(env.statement)

        if LN.is_quorum(nodes, get_qset, local_qset=self.local_node.qset):
            old = self.heard_from_quorum
            self.heard_from_quorum = True
            if not old:
                tl = self.slot.scp.timeline
                if tl.enabled:
                    tl.record(self.slot.slot_index, "ballot.quorum",
                              {"heard": True, "n": len(nodes),
                               "ballot_n": self.current[0]})
                self.driver.ballot_did_hear_from_quorum(
                    self.slot.slot_index, self.current)
                if self.phase != Phase.EXTERNALIZE:
                    self._start_timer()
            if self.phase == Phase.EXTERNALIZE:
                self._stop_timer()
        else:
            if self.heard_from_quorum:
                tl = self.slot.scp.timeline
                if tl.enabled:
                    tl.record(self.slot.slot_index, "ballot.quorum",
                              {"heard": False, "n": len(nodes)})
            self.heard_from_quorum = False
            self._stop_timer()

    def _start_timer(self) -> None:
        timeout = self.driver.compute_timeout(self.current[0], False)
        self.driver.setup_timer(
            self.slot.slot_index, BALLOT_TIMER, timeout,
            self.ballot_timer_expired)

    def _stop_timer(self) -> None:
        self.driver.setup_timer(
            self.slot.slot_index, BALLOT_TIMER, 0.0, None)

    # -- introspection -----------------------------------------------------

    def get_json_info(self) -> dict:
        return {
            "phase": self.phase.name,
            "ballot": self.current,
            "prepared": self.prepared,
            "preparedPrime": self.prepared_prime,
            "high": self.high,
            "commit": self.commit,
            "heard": self.heard_from_quorum,
        }

    def externalized_value(self) -> Optional[bytes]:
        if self.phase == Phase.EXTERNALIZE:
            return self.commit[1]
        return None
