"""Herder: glue between SCP, the transaction queue, and the ledger
(ref src/herder/HerderImpl.cpp + HerderSCPDriver.cpp — SURVEY.md §2.2).

States: BOOTING -> TRACKING / NOT-TRACKING (out-of-sync recovery).  Drives
one SCP round per ledger: triggerNextLedger builds a TxSetFrame from the
queue, nominates (txSetHash, closeTime), and applies externalized values
via LedgerManager.  In MANUAL_CLOSE/RUN_STANDALONE mode the SCP round is
short-circuited (ref Config.RUN_STANDALONE) but the same value/close path
runs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..crypto.ed25519 import verify_miss_stats
from ..ledger.ledger_manager import LedgerCloseData
from ..scp import SCP, EnvelopeState, SCPDriver, ValidationLevel
from ..scp.local_node import make_qset, qset_hash
from ..utils import tracing
from ..utils.clock import VirtualTimer
from ..xdr import XdrError, types as T, xdr_sha256
from .tx_queue import TransactionQueue
from .tx_set import TxSetFrame

# protocol constants (ref src/herder/Herder.cpp:7-18)
MAX_SCP_TIMEOUT_SECONDS = 240
CONSENSUS_STUCK_TIMEOUT_SECONDS = 35
LEDGER_VALIDITY_BRACKET = 100
MAX_TIME_SLIP_SECONDS = 60
NODE_EXPIRATION_SECONDS = 240
SCP_EXTRA_LOOKBACK_LEDGERS = 3

#: the phases of a manual close in the ledger's record, each a self time;
#: the rest of the call is its ``unattributed`` time
MANUAL_CLOSE_PHASES = ("trigger", "scp", "scp_persist", "close_ledger",
                       "drain", "ledger_closed")


def _state_reads(now: tuple, before: tuple, prefix: str) -> dict:
    """Entry-cache misses and bucket-tier reads (count, ms) between two
    readings of ``LedgerTxnRoot.state_read_stats``, under ``prefix``."""
    return {prefix + "cache_misses": now[0] - before[0],
            prefix + "state_reads": now[1] - before[1],
            prefix + "state_read_ms": (now[2] - before[2]) * 1000.0}


class HerderState:
    BOOTING = 0
    TRACKING = 1
    NOT_TRACKING = 2


class HerderSCPDriver(SCPDriver):
    """The only SCPDriver subclass: binds slots to ledger seqs and values
    to StellarValue XDR (ref src/herder/HerderSCPDriver.cpp)."""

    def __init__(self, herder):
        self.herder = herder
        self.app = herder.app
        # overlay's cross-peer signature batch primes verdicts here so
        # verify_envelope becomes a dict hit for batched envelopes
        # (bounded FIFO; identical verdicts either way)
        from collections import OrderedDict

        self._sig_verdicts: "OrderedDict" = OrderedDict()

    # -- values ------------------------------------------------------------

    def validate_value(self, slot_index, value, nomination):
        try:
            sv = T.StellarValue.decode(value)
        except Exception:
            return ValidationLevel.INVALID
        lm = self.app.ledger_manager
        if slot_index != lm.last_closed_seq() + 1:
            # not the slot we're applying next: structurally fine
            return ValidationLevel.MAYBE_VALID
        # close time must move forward and not be absurdly in the future
        lcl = lm.last_closed_header()
        if sv.closeTime <= lcl.scpValue.closeTime:
            return ValidationLevel.INVALID
        if sv.closeTime > self.app.clock.system_now() + \
                MAX_TIME_SLIP_SECONDS:
            return ValidationLevel.INVALID
        # every carried upgrade must be applicable — voting for a value
        # whose upgrades we'd skip at close would fork state (ref
        # validateValueHelper running Upgrades::isValid per upgrade)
        from .upgrades import VALID as UPGRADE_VALID
        from .upgrades import is_valid_for_apply

        for raw_up in sv.upgrades:
            validity, _ = is_valid_for_apply(raw_up, lcl, self.app.config)
            if validity != UPGRADE_VALID:
                return ValidationLevel.INVALID
        tx_set = self.herder.pending_envelopes.get_tx_set(sv.txSetHash)
        if tx_set is None:
            return ValidationLevel.MAYBE_VALID
        if not tx_set.check_valid(lm.root, lm.last_closed_hash()):
            return ValidationLevel.INVALID
        if nomination:
            return ValidationLevel.VOTE_TO_NOMINATE
        return ValidationLevel.FULLY_VALIDATED

    def combine_candidates(self, slot_index, candidates):
        """Pick the candidate with max (ops, closeTime, hash) — the
        reference's protocol-14+ value comparison (ref combineCandidates
        :615 + compareValues)."""
        best = None
        best_key = None
        for v in candidates:
            try:
                sv = T.StellarValue.decode(v)
            except XdrError:
                # candidates already passed validate_value; anything but
                # a typed decode error here is a runtime bug that must
                # stay loud, not a value to skip silently
                continue
            ts = self.herder.pending_envelopes.get_tx_set(sv.txSetHash)
            n_ops = ts.size_op() if ts is not None else 0
            key = (n_ops, sv.closeTime, v)
            if best_key is None or key > best_key:
                best_key = key
                best = v
        return best

    # -- envelopes ---------------------------------------------------------

    def sign_envelope(self, env) -> None:
        sk = self.app.config.node_secret()
        body = T.EnvelopeType.encode(T.EnvelopeType.ENVELOPE_TYPE_SCP) + \
            self.app.config.network_id() + \
            T.SCPStatement.encode(env.statement)
        from ..crypto import sha256

        env.signature = sk.sign(sha256(body))
        # SCPEnvelope encodes are memoized; the signature write above is
        # the type's one post-construction mutation — drop any memo so a
        # pre-sign encode can never leak stale bytes
        env.__dict__.pop("_xdr_enc", None)

    def envelope_sig_triple(self, env) -> tuple:
        """(pubkey, signature, signed-payload-hash) of one envelope —
        the unit the overlay's cross-peer signature batch verifies."""
        from ..crypto import sha256

        body = T.EnvelopeType.encode(T.EnvelopeType.ENVELOPE_TYPE_SCP) + \
            self.app.config.network_id() + \
            T.SCPStatement.encode(env.statement)
        return (env.statement.nodeID.value, env.signature, sha256(body))

    def prime_sig_verdicts(self, triple_verdicts) -> None:
        for triple, ok in triple_verdicts:
            self._sig_verdicts[triple] = bool(ok)
        while len(self._sig_verdicts) > 8192:
            self._sig_verdicts.popitem(last=False)

    def verify_envelope(self, env) -> bool:
        from ..crypto import verify_sig

        triple = self.envelope_sig_triple(env)
        cached = self._sig_verdicts.get(triple)
        if cached is not None:
            return cached
        return verify_sig(*triple)

    def emit_envelope(self, env) -> None:
        self.herder.broadcast_scp(env)

    def get_qset(self, h: bytes):
        return self.herder.pending_envelopes.get_qset(h)

    # -- timers ------------------------------------------------------------

    def setup_timer(self, slot_index, timer_id, timeout, cb) -> None:
        key = (slot_index, timer_id)
        old = self.herder._scp_timers.pop(key, None)
        if old is not None:
            old.cancel()
        tl = self.herder.scp.timeline
        arming = cb is not None and timeout > 0
        if tl.enabled and (arming or old is not None):
            # timer lifecycle on the slot timeline: arms and real
            # cancels (a cancel of nothing is protocol noise)
            fields = {"timer": "nom" if timer_id == 0 else "ballot"}
            if arming:
                fields["timeout"] = round(float(timeout), 3)
            tl.record(slot_index,
                      "timer.arm" if arming else "timer.cancel", fields)
        if not arming:
            return
        t = VirtualTimer(self.app.clock, owner=self.app)
        t.expires_from_now(timeout)
        t.async_wait(cb)
        self.herder._scp_timers[key] = t

    def compute_timeout(self, round_number, is_nomination) -> float:
        return float(min(round_number + 1,
                         self.app.config.MAX_SCP_TIMEOUT_SECONDS))

    # -- externalization ---------------------------------------------------

    def value_externalized(self, slot_index, value) -> None:
        self.herder.value_externalized(slot_index, value)


class PendingEnvelopes:
    """Holds SCP envelopes until their tx sets / qsets are available;
    dedups; feeds ready envelopes to SCP
    (ref src/herder/PendingEnvelopes.cpp)."""

    def __init__(self, herder):
        self.herder = herder
        self.tx_sets: Dict[bytes, TxSetFrame] = {}
        self.qsets: Dict[bytes, object] = {}
        self.pending: Dict[bytes, List] = {}  # missing-hash -> envelopes
        # tx-set hash -> the highest ledger seq known to reference it
        # (the LCL at add, raised to any SCP slot whose statements name
        # the hash): the retention key prune_below sweeps on.  Found by
        # the r13 sustained-load soak: without pruning, a node under
        # traffic retains EVERY proposal's TxSetFrame (frames,
        # envelopes, signature caches) forever — the RSS slope the
        # vitals sampler flagged (ref PendingEnvelopes::slotClosed
        # discarding per closed slot).  Keying on the REFERENCING slot
        # matters for a node that fell behind: a set fetched for a
        # far-future slot must survive the catchup closes in between.
        self._tx_set_seen: Dict[bytes, int] = {}

    def add_tx_set(self, tx_set: TxSetFrame) -> None:
        h = tx_set.contents_hash()
        self.tx_sets[h] = tx_set
        seen = self.herder.app.ledger_manager.last_closed_seq()
        waiting = self.pending.pop(h, [])
        if waiting:
            seen = max(seen, max(e.statement.slotIndex
                                 for e in waiting))
        if seen > self._tx_set_seen.get(h, -1):
            self._tx_set_seen[h] = seen
        for env in waiting:
            self.herder.deliver_ready_envelope(env)

    def note_referenced(self, h: bytes, slot_index: int) -> None:
        """Raise a held tx set's retention line to ``slot_index`` — a
        live SCP slot still names it, so prune_below must not drop it
        until that slot itself ages out."""
        if h in self._tx_set_seen and \
                slot_index > self._tx_set_seen[h]:
            self._tx_set_seen[h] = slot_index

    def add_qset(self, qset) -> None:
        h = qset_hash(qset)
        self.qsets[h] = qset
        for env in self.pending.pop(h, []):
            self.herder.deliver_ready_envelope(env)

    def get_tx_set(self, h: bytes) -> Optional[TxSetFrame]:
        return self.tx_sets.get(h)

    def get_qset(self, h: bytes):
        return self.qsets.get(h)

    def missing_for(self, env) -> List[bytes]:
        from ..scp.statement import companion_qset_hash, pledge_type

        st = env.statement
        missing = []
        qh = companion_qset_hash(st)
        if self.get_qset(qh) is None:
            missing.append(qh)
        for vh in _value_tx_set_hashes(st):
            if self.get_tx_set(vh) is None:
                missing.append(vh)
            else:
                # already held: this statement's slot keeps it alive
                self.note_referenced(vh, st.slotIndex)
        return missing

    def record_pending(self, env, missing: List[bytes]) -> None:
        for h in missing:
            self.pending.setdefault(h, []).append(env)

    def prune_below(self, seq: int) -> int:
        """Drop tx sets last relevant before ledger ``seq`` (the same
        retention line the SCP slots use) and pending-fetch envelopes
        for slots below it.  qsets stay: they dedup by hash across the
        whole network and are few.  Returns tx sets dropped."""
        stale = sorted(h for h, s in self._tx_set_seen.items()
                       if s < seq)
        for h in stale:
            del self._tx_set_seen[h]
            self.tx_sets.pop(h, None)
        for h in sorted(self.pending):
            kept = [e for e in self.pending[h]
                    if e.statement.slotIndex >= seq]
            if kept:
                self.pending[h] = kept
            else:
                del self.pending[h]
        return len(stale)


def _value_tx_set_hashes(st) -> List[bytes]:
    from ..scp import statement as S

    values = []
    if S.pledge_type(st) == S.ST_NOMINATE:
        values = S.nomination_values(st)
    else:
        values = list(S.ballot_statement_values(st))
    out = []
    for v in values:
        try:
            sv = T.StellarValue.decode(v)
            out.append(sv.txSetHash)
        except XdrError:
            pass  # malformed value in a peer statement: no tx set to fetch
    return out


class Herder:
    def __init__(self, app):
        self.app = app
        self.state = HerderState.BOOTING
        self.tx_queue = TransactionQueue(app)
        self.driver = HerderSCPDriver(self)
        self.pending_envelopes = PendingEnvelopes(self)
        cfg = app.config
        qset = self._build_qset(cfg)
        from ..scp.timeline import SCPTimeline

        self.scp = SCP(self.driver, cfg.node_id(),
                       cfg.NODE_IS_VALIDATOR, qset,
                       tally_backend=getattr(cfg, "SCP_TALLY_BACKEND",
                                             "host"),
                       timeline=SCPTimeline(
                           clock=app.clock,
                           enabled=bool(getattr(
                               cfg, "SCP_TIMELINE_ENABLED", True)),
                           max_slots=int(getattr(
                               cfg, "SCP_TIMELINE_SLOTS", 32)),
                           per_slot=int(getattr(
                               cfg, "SCP_TIMELINE_EVENTS_PER_SLOT", 256))),
                       # the tensor tallies run on the node's device (the
                       # host backend never reads it)
                       device=app.device)
        self.pending_envelopes.add_qset(qset)
        from .quorum_tracker import QuorumTracker

        self.quorum_tracker = QuorumTracker(cfg.node_id(), qset)
        from .quorum_health import QuorumHealthMonitor

        self.quorum_health = QuorumHealthMonitor(self)
        self._heard_qsets: Dict[bytes, object] = {}
        self._scp_timers: Dict = {}
        self.trigger_timer = VirtualTimer(app.clock, owner=app)
        self.on_externalized: List[Callable] = []
        self._tracking_slot: Optional[int] = None
        # consensus failure detection (ref HerderImpl.cpp:432 +
        # CONSENSUS_STUCK_TIMEOUT_SECONDS, Herder.cpp:9): no externalize
        # within the stuck window => NOT_TRACKING + periodic recovery
        self.tracking_timer = VirtualTimer(app.clock, owner=app)
        self.out_of_sync_timer = VirtualTimer(app.clock, owner=app)
        self.lost_sync_count = 0
        # slots the persisted SCP history shows EXTERNALIZED beyond the
        # durable LCL (a crash between SCP persistence and the ledger
        # commit — e.g. inside the pipelined close's tail window): the
        # restored protocol state is already terminal, so SCP will
        # never re-announce them; the herder replays the close itself
        # once the value's tx set is fetched from a peer
        self._restored_externalized: Dict[int, bytes] = {}
        # what the node measured toward the next ledger before its close
        # (ms, counts): admission since the previous close, the trigger,
        # SCP so far, the SCP history's write; the close's record starts
        # from it (LedgerManager.seed_close_record)
        self._record = self._new_record()
        # LedgerTxnRoot.state_read_stats when the last manual close ended
        self._reads_at_close = None
        # runs while SCP works on the node's own nomination: its laps
        # are SCP's self time
        self._scp_clock = None

    @staticmethod
    def _new_record() -> dict:
        return {"admit": 0.0, "admit_count": 0, "admit_verify": 0.0,
                "admit_verify_count": 0}

    def _note(self, ms: dict) -> None:
        for k, v in ms.items():
            self._record[k] = self._record.get(k, 0.0) + v

    @staticmethod
    def _build_qset(cfg):
        if cfg.QUORUM_SET:
            inner = [
                make_qset(s["threshold"], s["validators"])
                for s in cfg.QUORUM_SET.get("inner_sets", [])]
            return make_qset(
                cfg.QUORUM_SET["threshold"],
                cfg.QUORUM_SET["validators"],
                inner=inner)
        # standalone: self-quorum
        return make_qset(1, [cfg.node_id()])

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.state = HerderState.TRACKING
        self._restore_scp_state()
        if not self.app.config.MANUAL_CLOSE:
            self._arm_trigger()
            self._arm_tracking_timer()

    def _restore_scp_state(self) -> None:
        """Re-ingest this node's persisted SCP envelopes for the latest
        slot so a restarted validator can answer GET_SCP_STATE and
        re-advertise its externalize immediately (ref Herder::start
        restoring from HerderPersistence)."""
        row = self.app.database.execute(
            "SELECT MAX(ledgerseq) FROM scphistory").fetchone()
        if not row or row[0] is None:
            return
        seq = row[0]
        from ..scp.statement import ST_EXTERNALIZE, pledge_type

        lcl = self.app.ledger_manager.last_closed_seq()
        for (raw,) in self.app.database.execute(
                "SELECT envelope FROM scphistory WHERE ledgerseq=?",
                (seq,)).fetchall():
            try:
                env = T.SCPEnvelope.decode(raw)
            except XdrError:
                continue  # torn row in scphistory: skip, don't wedge restore
            # statement state only — no protocol transitions (tx sets
            # referenced by old envelopes are gone after a restart)
            st = env.statement
            slot = self.scp.get_slot(st.slotIndex)
            slot.set_state_from_envelope(env)
            # SCP history commits at externalize, BEFORE the ledger's
            # durable commit — a crash in between (the pipelined tail
            # window) restores a slot whose protocol state is terminal
            # while the ledger never applied it.  Remember the value:
            # recv_tx_set replays the close once a peer supplies the
            # tx set (the slot's own SCP machine stays silent forever)
            if st.slotIndex > lcl and \
                    pledge_type(st) == ST_EXTERNALIZE:
                self._restored_externalized.setdefault(
                    st.slotIndex, st.pledges.value.commit.value)

    def _arm_trigger(self) -> None:
        cfg = self.app.config
        self.trigger_timer.expires_from_now(
            cfg.EXP_LEDGER_TIMESPAN_SECONDS)
        self.trigger_timer.async_wait(self.trigger_next_ledger)

    # -- failure detection / out-of-sync recovery ---------------------------

    def _stuck_timeout(self) -> float:
        cfg = self.app.config
        if cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING:
            # scale with the accelerated close cadence
            return max(cfg.EXP_LEDGER_TIMESPAN_SECONDS * 7, 5.0)
        return float(CONSENSUS_STUCK_TIMEOUT_SECONDS)

    def _arm_tracking_timer(self) -> None:
        """Re-armed on every externalize; firing means consensus is stuck
        (ref trackingHeartBeat / CONSENSUS_STUCK_TIMEOUT_SECONDS)."""
        self.tracking_timer.cancel()
        self.tracking_timer.expires_from_now(self._stuck_timeout())
        self.tracking_timer.async_wait(self._herder_out_of_sync)

    def _herder_out_of_sync(self) -> None:
        """ref herderOutOfSync: lost consensus — flip to NOT_TRACKING and
        start periodic recovery."""
        if self.state != HerderState.TRACKING:
            return
        self.state = HerderState.NOT_TRACKING
        self.lost_sync_count += 1
        self.app.metrics.counter("herder.lost-sync").inc()
        from ..utils.logging import get_logger

        get_logger("Herder").warning(
            "lost consensus sync (no externalize within %.1fs); "
            "starting out-of-sync recovery", self._stuck_timeout())
        self._out_of_sync_recovery()

    def _out_of_sync_recovery(self) -> None:
        """ref outOfSyncRecovery (HerderImpl.cpp:432): re-ask peers for
        SCP state from our LCL and rebroadcast our latest messages, on a
        short period until tracking resumes."""
        if self.state == HerderState.TRACKING:
            return
        om = self.app.overlay_manager
        if om is not None:
            from ..xdr import overlay_types as O

            seq = self.app.ledger_manager.last_closed_seq()
            for p in list(om.authenticated.values()):
                p.send_message(O.StellarMessage.make(
                    O.MessageType.GET_SCP_STATE, seq))
            for slot_index in sorted(self.scp.slots):
                for env in self.scp.get_latest_messages_send(slot_index):
                    om.broadcast_scp(env)
        period = max(self.app.config.EXP_LEDGER_TIMESPAN_SECONDS, 2.0)
        self.out_of_sync_timer.cancel()
        self.out_of_sync_timer.expires_from_now(period)
        self.out_of_sync_timer.async_wait(self._out_of_sync_recovery)

    # -- tx admission (north-star hot path #1) ------------------------------

    def recv_transaction(self, env) -> int:
        """HTTP 'tx' or peer TRANSACTION message -> queue
        (ref recvTransaction :458)."""
        verifies0, verify_s0 = verify_miss_stats()
        with self.app.tracer.span("herder.tx.admit") as sp:
            res = self.tx_queue.try_add(env)
            if res == TransactionQueue.ADD_STATUS_PENDING:
                self.app.broadcast_transaction(env)
            if sp.args is None:
                sp.args = {}
            sp.args["status"] = res
        verifies, verify_s = verify_miss_stats()
        rec = self._record
        rec["admit"] += sp.seconds * 1000.0
        rec["admit_count"] += 1
        rec["admit_verify"] += (verify_s - verify_s0) * 1000.0
        rec["admit_verify_count"] += verifies - verifies0
        return res

    # -- SCP plumbing -------------------------------------------------------

    def scp_slot_bracket(self) -> tuple:
        """[min, max] slot indices this node will process SCP traffic
        for (ref Herder::recvSCPEnvelope's minLedgerSeq/maxLedgerSeq
        checks): below = already closed and purged (a stale replay would
        re-create dead Slot objects forever), above = beyond the
        validity bracket (a far-future flood would grow slot state
        unboundedly).  The upper bound anchors on the newest slot
        CONSENSUS has externalized (ref nextConsensusLedgerIndex +
        LEDGER_VALIDITY_BRACKET), not the local LCL: a node catching up
        keeps its LCL parked at the restore point for minutes while it
        must keep ingesting (and buffering) live traffic 1000+ slots
        ahead.  Before the first externalize this session there is no
        tracked slot to anchor on, so no upper bound applies — a cold
        node must be able to learn how far behind it is."""
        lcl = self.app.ledger_manager.last_closed_seq()
        lookback = max(SCP_EXTRA_LOOKBACK_LEDGERS,
                       self.app.config.MAX_SLOTS_TO_REMEMBER)
        if (self.state == HerderState.TRACKING
                and self._tracking_slot is not None):
            hi = max(lcl, self._tracking_slot) + LEDGER_VALIDITY_BRACKET
        else:
            hi = 2 ** 63
        return (max(1, lcl - lookback + 1), hi)

    def recv_scp_envelope(self, env) -> EnvelopeState:
        """ref recvSCPEnvelope :624 + PendingEnvelopes fetch logic."""
        prof = self.app.clock.profiler
        if prof is None:
            return self._recv_scp_envelope(env)
        # crank wall attribution: SCP ingest (quorum-slice evaluation
        # included) usually runs inside an overlay delivery dispatch —
        # carve it into "consensus"; a close it triggers nests into
        # "ledger" via LedgerManager's own scope
        tok = prof.scope_begin("consensus")
        try:
            return self._recv_scp_envelope(env)
        finally:
            prof.scope_end(tok)

    def _recv_scp_envelope(self, env) -> EnvelopeState:
        lo, hi = self.scp_slot_bracket()
        slot = env.statement.slotIndex
        if not lo <= slot <= hi:
            # stale replay / far-future flood: discard without touching
            # SCP state (the reference's DISCARDED status)
            self.app.metrics.counter("herder.scp.discarded").inc()
            return EnvelopeState.INVALID
        if env.statement.nodeID.value == self.app.config.node_id():
            # ref ENVELOPE_STATUS_SKIPPED_SELF: never ingest our own
            # statements from the network — the local protocol already
            # holds the authoritative copy, and a flooded-back variant
            # (e.g. an equivocating twin signed while Byzantine) would
            # supersede our record and wedge the next honest emission
            self.app.metrics.counter("herder.scp.self-skipped").inc()
            return EnvelopeState.VALID
        with self.app.tracer.span("herder.scp.recv",
                                  slot=env.statement.slotIndex):
            missing = self.pending_envelopes.missing_for(env)
            if missing:
                self.pending_envelopes.record_pending(env, missing)
                self.app.request_scp_items(missing)
                return EnvelopeState.VALID
            return self.deliver_ready_envelope(env)

    def deliver_ready_envelope(self, env) -> EnvelopeState:
        """The single seam every ready envelope passes through: SCP
        processing (which verifies the signature), then quorum tracking
        only for envelopes that were not rejected — a forged statement
        must not pollute the tracked topology."""
        res = self.scp.receive_envelope(env)
        if res != EnvelopeState.INVALID:
            self._track_quorum(env)
        return res

    def _track_quorum(self, env) -> None:
        """Grow the known transitive quorum from a verified envelope (ref
        HerderImpl::updateTransitiveQuorum via QuorumTracker)."""
        from ..scp.statement import companion_qset_hash

        node = env.statement.nodeID.value
        qset = self.pending_envelopes.get_qset(
            companion_qset_hash(env.statement))
        if qset is None:
            return
        self._heard_qsets[node] = qset
        if not self.quorum_tracker.expand(node, qset):
            # inconsistent announcement: rebuild from everything heard
            self.quorum_tracker.rebuild(self._heard_qsets.get,
                                        self.scp.local_node.qset)

    def recv_tx_set(self, tx_set: TxSetFrame) -> None:
        self.pending_envelopes.add_tx_set(tx_set)
        self._maybe_replay_restored_externalize()

    def _maybe_replay_restored_externalize(self) -> None:
        """Close a slot the persisted SCP history already externalized
        but the ledger never durably applied (crash inside the
        pipelined close's seal-to-commit window): the restored SCP
        state is terminal and never re-announces, so once the tx set
        arrives from a peer the herder replays the externalization
        itself."""
        lm = self.app.ledger_manager
        slot = lm.last_closed_seq() + 1
        # anything at or below the LCL got applied after all
        for s in [s for s in self._restored_externalized if s < slot]:
            del self._restored_externalized[s]
        value = self._restored_externalized.get(slot)
        if value is None:
            return
        try:
            sv = T.StellarValue.decode(value)
        except XdrError:
            del self._restored_externalized[slot]
            return
        if self.pending_envelopes.get_tx_set(sv.txSetHash) is None:
            return
        del self._restored_externalized[slot]
        from ..utils.logging import get_logger

        get_logger("Herder").info(
            "replaying restored externalized slot %d (crash between "
            "SCP persistence and ledger commit)", slot)
        self.value_externalized(slot, value)

    def recv_qset(self, qset) -> None:
        self.pending_envelopes.add_qset(qset)

    def broadcast_scp(self, env) -> None:
        self.app.broadcast_scp_message(env)

    # -- ledger trigger ----------------------------------------------------

    def trigger_next_ledger(self, max_tx_set_size: Optional[int] = None
                            ) -> None:
        """Build the tx set + close value, then nominate
        (ref triggerNextLedger :1200-1290)."""
        lm = self.app.ledger_manager
        lcl_header = lm.last_closed_header()
        lcl_hash = lm.last_closed_hash()
        slot = lm.last_closed_seq() + 1

        with self.app.tracer.span("herder.trigger.txset", slot=slot) as sp:
            frames = self.tx_queue.get_transactions()
            # exact-key footprint prefetch (ledger/close_pipeline.py):
            # a worker batch-loads the candidates' declared LedgerKey
            # sets from the bucket tier WHILE this thread builds the
            # proposal; adopted below, so the preplan's sponsor reads
            # and the close's prefetch phase hit a warm cache
            prefetch = lm.pipeline.stage_prefetch(frames, lm.root)
            tx_set = TxSetFrame.make_from_transactions(
                self.app.config.network_id(), lcl_hash, frames, lm.root,
                max_tx_set_size or lcl_header.maxTxSetSize,
                lcl_header.baseFee,
                max_dex_ops=self.app.config.MAX_DEX_TX_OPERATIONS)
            self.pending_envelopes.add_tx_set(tx_set)
            # lifecycle stage "txset": the tx made this proposal
            self.app.txtracer.stamp_frames(tx_set.frames, "txset")
            lm.pipeline.adopt_prefetch(prefetch, lm.root)
            # plan the parallel apply of our own proposal NOW, off the
            # close's critical path; the close consumes the cached plan
            # when this exact set externalizes (apply/executor.py)
            self.app.parallel_apply.preplan(tx_set, lm.root)
        self._note({"trigger": sp.seconds * 1000.0})

        close_time = max(
            int(self.app.clock.system_now()),
            lcl_header.scpValue.closeTime + 1)
        sv = T.StellarValue.make(
            txSetHash=tx_set.contents_hash(),
            closeTime=close_time,
            upgrades=self._pending_upgrades(),
            ext=T.StellarValue.fields[3][1].make(
                T.StellarValueType.STELLAR_VALUE_BASIC))
        value = T.StellarValue.encode(sv)

        # single-node standalone networks externalize through the same SCP
        # slot (self-quorum makes the round instant)
        self.app.txtracer.stamp_frames(tx_set.frames, "nominate")
        self._scp_clock = tracing.stopwatch().__enter__()
        try:
            self.scp.nominate(slot, value, lcl_hash)
        finally:
            clock, self._scp_clock = self._scp_clock, None
        scp = {"scp": clock.lap() * 1000.0}
        if lm.last_closed_seq() == slot:  # the slot closed inside SCP
            lm.add_close_phases(scp)
        else:
            self._note(scp)
        if not self.app.config.MANUAL_CLOSE:
            self._arm_trigger()

    def _pending_upgrades(self) -> List[bytes]:
        from .upgrades import create_upgrades_for

        return create_upgrades_for(
            self.app.ledger_manager.last_closed_header(), self.app.config)

    # -- externalization ---------------------------------------------------

    def value_externalized(self, slot_index: int, value: bytes) -> None:
        """ref valueExternalized :315 + processExternalized :266."""
        if slot_index <= self.app.ledger_manager.last_closed_seq():
            return  # already applied (e.g. restored SCP state at boot)
        if self._scp_clock is not None:
            self._note({"scp": self._scp_clock.lap() * 1000.0})
        sv = T.StellarValue.decode(value)
        tx_set = self.pending_envelopes.get_tx_set(sv.txSetHash)
        if tx_set is None:
            raise RuntimeError("externalized value with unknown tx set")
        from ..utils.logging import get_logger

        get_logger("SCP").debug(
            "externalized slot %d (%d txs, closeTime %d)",
            slot_index, tx_set.size(), sv.closeTime)
        self.app.txtracer.stamp_frames(tx_set.frames, "externalize")
        back_in_sync = self.state != HerderState.TRACKING
        self.state = HerderState.TRACKING
        self._tracking_slot = slot_index
        if back_in_sync:
            self.out_of_sync_timer.cancel()
        if not self.app.config.MANUAL_CLOSE:
            self._arm_tracking_timer()
        db = self.app.database
        db.take_commit_stats()  # this ledger's flushes on this thread
        with tracing.stopwatch() as sw:
            self._persist_scp_history(slot_index)
        self._note({"scp_persist": sw.seconds * 1000.0})
        lm = self.app.ledger_manager
        if slot_index == lm.last_closed_seq() + 1:
            lm.seed_close_record(
                {**self._record, **self.tx_queue.take_admit_stages()})
            self._record = self._new_record()
            lm.close_ledger(LedgerCloseData(slot_index, tx_set, sv))
            with tracing.stopwatch() as sw:
                self.ledger_closed(slot_index)
            commits, commit_s = db.take_commit_stats()
            lm.add_close_phases({"ledger_closed": sw.seconds * 1000.0,
                                 "db_commits": commits,
                                 "db_commit_ms": commit_s * 1000.0})
        else:
            # gapped: buffer only — housekeeping runs per actually-closed
            # ledger via ledger_closed (aging the queue for slots we never
            # applied would wrongly ban pending txs)
            self.app.catchup_manager.buffer_externalized(
                slot_index, tx_set, sv)
        for cb in self.on_externalized:
            cb(slot_index, sv)
        if self._scp_clock is not None:
            self._scp_clock.lap()  # what ran here was not SCP's work

    def ledger_closed(self, slot_index: int) -> None:
        """Housekeeping after a ledger actually closes locally (also called
        by the catchup manager when it drains buffered ledgers)."""
        lm = self.app.ledger_manager
        # quorum-health evaluation first, while the closed slot's
        # envelope state is still whole (purge below keeps only the
        # kept slot, which is this one — but order still matters for
        # monitors reading neighbors)
        self.quorum_health.on_ledger_closed(slot_index)
        self.tx_queue.shift(lm.root)
        if self.app.overlay_manager is not None:
            # expire flood dedup records past their TTL (ref
            # OverlayManager::clearLedgersBelow): without this the
            # floodgate grows per flooded message forever AND absorbs
            # stale replays that the slot bracket is supposed to
            # discard — both surfaced by the chaos stale_replay
            # scenario
            self.app.overlay_manager.floodgate.clear_below(slot_index)
        cutoff = max(0, slot_index - max(
            SCP_EXTRA_LOOKBACK_LEDGERS,
            self.app.config.MAX_SLOTS_TO_REMEMBER))
        self.scp.purge_slots(cutoff, slot_index)
        # tx sets age out on the same line the slots do (r13 soak: the
        # unpruned map was the node's dominant RSS slope under load)
        self.pending_envelopes.prune_below(cutoff)

    def check_quorum_intersection(self, qmap=None, max_calls=None,
                                  max_seconds=None):
        """Run the quorum-intersection checker over the tracked network
        (ref CommandHandler 'quorum?intersection=true' +
        QuorumIntersectionChecker::create).  qmap defaults to the latest
        slot's per-node quorum sets plus the local node.  ``max_calls``
        / ``max_seconds`` override the config scan budget (the
        quorum-health monitor's periodic checks run on a much smaller
        allowance than the synchronous admin endpoint)."""
        from .quorum_intersection import check_quorum_intersection

        if qmap is None:
            # the tracked transitive quorum, topped up with the latest
            # slot's envelopes (covers nodes heard before tracking)
            qmap = dict(self.quorum_tracker.qset_map())
            qmap.setdefault(self.scp.local_node.node_id,
                            self.scp.local_node.qset)
            slot_idx = self.scp.get_high_slot_index()
            slot = self.scp.get_slot(slot_idx, create=False)
            if slot is not None:
                for env in slot.latest_envelopes():
                    node = env.statement.nodeID.value
                    q = slot.qset_from_statement(env.statement)
                    if q is not None:
                        qmap.setdefault(node, q)
        use_device = self.app.config.CRYPTO_BACKEND == "cuda"
        return check_quorum_intersection(
            qmap, use_device=use_device, device=self.app.device,
            max_calls=max_calls if max_calls is not None
            else self.app.config.QUORUM_INTERSECTION_MAX_CALLS,
            max_seconds=max_seconds if max_seconds is not None
            else self.app.config.QUORUM_INTERSECTION_TIMEOUT_SECONDS)

    def _persist_scp_history(self, slot_index: int) -> None:
        """Persist the slot's SCP envelopes for audit + history publish
        (ref HerderPersistenceImpl::saveSCPHistory).  The whole batch
        runs under the database's write-transaction scope: per-statement
        locking alone would let the close pipeline's tail transaction
        interleave between rows on the shared connection — its commit
        would absorb (or its rollback discard) half a slot's history."""
        slot = self.scp.slots.get(slot_index)
        if slot is None:
            return
        db = self.app.database
        with db.write_txn():
            for env in slot.latest_envelopes():
                db.execute(
                    "INSERT INTO scphistory(nodeid, ledgerseq, envelope) "
                    "VALUES(?,?,?)",
                    (env.statement.nodeID.value, slot_index,
                     T.SCPEnvelope.encode(env)))
            db.commit()

    # -- manual close (test/standalone) -------------------------------------

    def manual_close(self) -> int:
        """Close exactly one ledger now (ref CommandHandler manualclose).

        The ledger's record (``LedgerManager.last_close_phases``) gets the
        call's wall time, its start on the Unix clock, the part of it
        that no phase of ``MANUAL_CLOSE_PHASES`` holds, and the ledger
        state's cache misses and bucket-tier reads
        (``LedgerTxnRoot.state_read_stats``) in it (``close_``) and
        since the previous manual close ended (``admit_``)."""
        assert self.app.config.MANUAL_CLOSE
        lm = self.app.ledger_manager
        seq = lm.last_closed_seq()
        reads0 = lm.root.state_read_stats()
        with tracing.stopwatch() as sw:
            self.trigger_next_ledger()
        if lm.last_closed_seq() > seq:
            reads = lm.root.state_read_stats()
            whole = sw.seconds * 1000.0
            rec = lm.add_close_phases({
                "manual_close": whole,
                "t0_unix_ns": self.app.tracer.unix_ns(sw.t0),
                **_state_reads(reads0, self._reads_at_close or reads0,
                               "admit_"),
                **_state_reads(reads, reads0, "close_")})
            self._reads_at_close = reads
            parts = sum(rec.get(k, 0.0) for k in MANUAL_CLOSE_PHASES)
            lm.add_close_phases({"unattributed": max(0.0, whole - parts)})
        return lm.last_closed_seq()
