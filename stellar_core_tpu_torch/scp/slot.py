"""Slot: per-slot-index consensus state — routes envelopes to the nomination
or ballot protocol and provides the federated-voting primitives
(ref src/scp/Slot.h, Slot.cpp).
"""
from __future__ import annotations

from enum import IntEnum
from typing import Callable, Dict, List, Optional

from ..xdr import types as T
from . import local_node as LN
from .ballot import BallotProtocol
from .driver import BALLOT_TIMER, NOMINATION_TIMER  # noqa: F401
from .nomination import NominationProtocol
from .statement import companion_qset_hash, node_of, pledge_type


class EnvelopeState(IntEnum):
    INVALID = 0
    VALID = 1


class Slot:
    def __init__(self, slot_index: int, scp):
        self.slot_index = slot_index
        self.scp = scp
        self.nomination = NominationProtocol(self)
        self.ballot = BallotProtocol(self)
        self.fully_validated = scp.local_node.is_validator
        # historical statements for audit (ref mStatementsHistory)
        self.statements_history: List = []
        self.got_v_blocking = False
        backend = getattr(scp, "tally_backend", "host")
        if backend != "host":
            from .tally import TallyEngine

            self.tally = TallyEngine(self, backend, scp.tally_device)
        else:
            self.tally = None

    # -- plumbing ----------------------------------------------------------

    @property
    def driver(self):
        return self.scp.driver

    @property
    def local_node(self):
        return self.scp.local_node

    def qset_from_statement(self, st) -> Optional[object]:
        """Resolve the quorum set a statement pledges under (ref
        Slot::getQuorumSetFromStatement)."""
        h = companion_qset_hash(st)
        if h == self.local_node.qset_hash:
            return self.local_node.qset
        return self.driver.get_qset(h)

    def create_envelope(self, pledges) -> object:
        st = T.SCPStatement.make(
            nodeID=T.account_id(self.local_node.node_id),
            slotIndex=self.slot_index,
            pledges=pledges,
        )
        env = T.SCPEnvelope.make(statement=st, signature=b"")
        self.driver.sign_envelope(env)
        return env

    # -- envelope entry ----------------------------------------------------

    def process_envelope(self, envelope, self_: bool = False) -> EnvelopeState:
        st = envelope.statement
        if st.slotIndex != self.slot_index:
            raise ValueError("envelope for wrong slot")
        tl = self.scp.timeline
        if tl.enabled:
            # recorded BEFORE processing so the envelope precedes the
            # transitions it causes; the verdict is appended below.
            # Rejected envelopes are recorded too — a refused
            # equivocating twin is forensic witness material.
            from .timeline import statement_fingerprint, summarize_statement

            ev = {"from": node_of(st).hex()[:8],
                  "st": summarize_statement(st),
                  "fp": statement_fingerprint(st)}
            if self_:
                ev["self"] = True
            tl.record(self.slot_index, "env", ev)
        if pledge_type(st) == T.SCPStatementType.SCP_ST_NOMINATE:
            res = self.nomination.process_envelope(envelope)
        else:
            res = self.ballot.process_envelope(envelope, self_)
        if tl.enabled:
            ev["ok"] = res == EnvelopeState.VALID
        if res == EnvelopeState.VALID:
            self.statements_history.append(st)
        return res

    def nominate(self, value: bytes, prev_value: bytes,
                 timedout: bool = False) -> bool:
        return self.nomination.nominate(value, prev_value, timedout)

    def bump_state(self, value: bytes, force: bool) -> bool:
        return self.ballot.bump_state(value, force)

    def stop_nomination(self) -> None:
        self.nomination.stop_nomination()
        self.driver.setup_timer(
            self.slot_index, NOMINATION_TIMER, 0.0, None)

    def set_fully_validated(self, fv: bool) -> None:
        self.fully_validated = fv

    def get_latest_composite_candidate(self) -> Optional[bytes]:
        return self.nomination.latest_composite

    def latest_envelopes(self) -> list:
        """Per-node latest ballot envelopes (HerderPersistence's audit
        record, ref Slot::getLatestMessagesSend)."""
        return list(self.ballot.latest_envelopes.values())

    def current_state_envelopes(self) -> list:
        """EVERY remembered node's latest nomination + ballot envelopes,
        in canonical node order — the GET_SCP_STATE payload (ref
        Slot::processCurrentState feeding HerderImpl::sendSCPStateToPeer).
        Answering with only the local node's own messages is not enough
        on sparse topologies: a restarted validator's direct peers are
        not v-blocking for a tiered org quorum, so it could never accept
        the missed slots' outcomes and would stay wedged at its
        pre-crash LCL forever (chaos crash_restore on
        hierarchical_quorum exposed this).  Self-only when this slot is
        not fully validated, like the reference."""
        if not self.fully_validated:
            return self.latest_messages_send()
        by_node = dict(self.nomination.latest_nominations)
        out = sorted(by_node.items())
        out.extend(sorted(self.ballot.latest_envelopes.items()))
        return [env for _, env in out]

    def set_state_from_envelope(self, envelope) -> None:
        """Restore persisted statement state WITHOUT driving protocol
        transitions (ref Slot::setStateFromEnvelope — used by
        Herder::restoreSCPState after a restart): the envelope becomes
        the node's recorded latest message so GET_SCP_STATE and
        re-broadcast work, but no attempt* logic runs.  For the local
        node's OWN envelope the ballot protocol's b/p/p'/c/h/phase are
        rebuilt too — otherwise the restarted protocol runs from scratch
        and its first fresh emission is older than its own recorded
        statement, which the self-process refuses ("moved to a bad
        state", exposed by the chaos kill-restore scenario)."""
        st = envelope.statement
        if st.slotIndex != self.slot_index:
            raise ValueError("envelope for wrong slot")
        if node_of(st) == self.local_node.node_id:
            self.ballot.set_state_from_envelope(envelope)
        self.ballot.latest_envelopes[node_of(st)] = envelope

    # -- federated voting --------------------------------------------------

    def federated_accept(
        self,
        voted_predicate: Callable,
        accepted_predicate: Callable,
        envelopes: Dict[bytes, object],
    ) -> bool:
        """accept iff a v-blocking set accepts, or a quorum (w.r.t. the
        local node) votes-or-accepts (ref Slot::federatedAccept).

        Routed through the port's quorum ops (ops/quorum.py) on the SCP
        instance's tally device when it runs with tally backend
        "tensor"/"both"; host math otherwise and for >2-level quorum
        sets."""
        if self.tally is not None:
            verdict = self.tally.federated_accept(
                voted_predicate, accepted_predicate, envelopes)
            if verdict is not None:
                return verdict
        accepted_nodes = {
            n for n, env in envelopes.items()
            if accepted_predicate(env.statement)
        }
        if LN.is_v_blocking(self.local_node.qset, accepted_nodes):
            return True
        vote_or_accept = {
            n for n, env in envelopes.items()
            if accepted_predicate(env.statement)
            or voted_predicate(env.statement)
        }
        return self._host_is_quorum(vote_or_accept, envelopes)

    def federated_ratify(
        self, voted_predicate: Callable, envelopes: Dict[bytes, object]
    ) -> bool:
        if self.tally is not None:
            verdict = self.tally.federated_ratify(
                voted_predicate, envelopes)
            if verdict is not None:
                return verdict
        voted = {
            n for n, env in envelopes.items()
            if voted_predicate(env.statement)
        }
        return self._host_is_quorum(voted, envelopes)

    def _host_is_quorum(self, nodes, envelopes) -> bool:
        def get_qset(node_id: bytes):
            env = envelopes.get(node_id)
            if env is None:
                return None
            return self.qset_from_statement(env.statement)

        return LN.is_quorum(nodes, get_qset,
                            local_qset=self.local_node.qset)

    # -- introspection -----------------------------------------------------

    def get_entire_state(self) -> dict:
        return {
            "index": self.slot_index,
            "nomination": self.nomination.get_json_info(),
            "ballot": self.ballot.get_json_info(),
            "fully_validated": self.fully_validated,
        }

    def latest_messages_send(self) -> List:
        """Messages to (re)send to peers to advertise current state
        (ref Slot::getLatestMessagesSend)."""
        out = []
        if self.fully_validated:
            nom = self.nomination.last_envelope_emit
            if nom is not None:
                out.append(nom)
            bal = self.ballot.last_envelope_emit
            if bal is not None:
                out.append(bal)
        return out
