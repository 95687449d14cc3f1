"""OverlayManager: connection lifecycle, flood fan-out, item fetching
(ref src/overlay/OverlayManagerImpl.cpp, Floodgate.cpp, ItemFetcher.h —
SURVEY.md §2.3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..crypto import sha256
from ..xdr import overlay_types as O
from ..xdr import types as T

FLOOD_RECORD_TTL_LEDGERS = 10


class Floodgate:
    """Dedup + fan-out of flood messages; remembers which peer already has
    what (ref Floodgate.cpp:61-120)."""

    def __init__(self):
        # msg hash -> {"peers": set of peer_ids that have it, "seq": ledger}
        self.records: Dict[bytes, dict] = {}
        # observational GC hook: clear_below hands the dropped hashes to
        # the flood tracker so tracked hop records retire into its ring;
        # never influences routing
        self.on_clear = None

    @staticmethod
    def msg_id(msg) -> bytes:
        return sha256(O.StellarMessage.encode(msg))

    def add_record(self, msg, from_peer_id: Optional[bytes],
                   ledger_seq: int, h: Optional[bytes] = None) -> bool:
        """Returns True if the message is NEW (should be processed +
        forwarded).  Callers that already hashed the message pass ``h``
        so the flood path hashes each message once."""
        if h is None:
            h = self.msg_id(msg)
        rec = self.records.get(h)
        if rec is None:
            rec = self.records[h] = {"peers": set(), "seq": ledger_seq}
            if from_peer_id is not None:
                rec["peers"].add(from_peer_id)
            return True
        if from_peer_id is not None:
            rec["peers"].add(from_peer_id)
        return False

    def peers_to_send(self, msg, authenticated_peers,
                      h: Optional[bytes] = None) -> List:
        if h is None:
            h = self.msg_id(msg)
        rec = self.records.setdefault(
            h, {"peers": set(), "seq": 0})
        out = [p for p in authenticated_peers
               if p.peer_id not in rec["peers"]]
        for p in out:
            rec["peers"].add(p.peer_id)
        return out

    def forget_peer(self, peer_id: bytes) -> int:
        """Drop a departed CONNECTION's footprint from every flood
        record (the reconnect-churn fix): the records are per-connection
        state in the reference (keyed by Peer pointer), but here they
        key on the node id, so without this a reconnecting peer would
        inherit the dead connection's have-set — never re-flooded items
        it lost with the old socket, and blamed for their duplicate
        echoes.  Returns the number of records touched."""
        n = 0
        for rec in self.records.values():
            if peer_id in rec["peers"]:
                rec["peers"].discard(peer_id)
                n += 1
        return n

    def clear_below(self, ledger_seq: int) -> None:
        cutoff = ledger_seq - FLOOD_RECORD_TTL_LEDGERS
        dead = [h for h, r in self.records.items() if r["seq"] < cutoff]
        for h in dead:
            del self.records[h]
        if dead and self.on_clear is not None:
            self.on_clear(dead)


class ItemTracker:
    """Tracks one missing item being fetched (ref Tracker.h:40)."""

    def __init__(self, item_hash: bytes, item_type: int):
        self.item_hash = item_hash
        self.item_type = item_type  # GET_TX_SET or GET_SCP_QUORUMSET
        self.asked: Set[bytes] = set()
        self.dont_have: Set[bytes] = set()
        self.tries = 0  # retry-timer firings (capped)


class OverlayManager:
    def __init__(self, app):
        from .survey import SurveyManager

        self.app = app
        self.pending_peers: List = []
        self.authenticated: Dict[bytes, object] = {}
        self.floodgate = Floodgate()
        # flood-propagation telemetry: retire tracked hop records when
        # the floodgate GCs them (utils/floodtrace.py)
        ft = getattr(app, "floodtracer", None)
        if ft is not None:
            self.floodgate.on_clear = ft.retire
        self.trackers: Dict[bytes, ItemTracker] = {}
        self.banned_peers: Set[bytes] = set()
        self.survey_manager = SurveyManager(app)
        # persisted peer DB + bans (present when the app has a Database;
        # bare sims construct OverlayManager before app.database exists —
        # only that case may degrade silently, real DB errors propagate)
        if getattr(app, "database", None) is not None and \
                hasattr(app.database, "conn"):
            from .peer_manager import BanManager, PeerManager

            self.peer_manager = PeerManager(app)
            self.ban_manager = BanManager(app)
            self.banned_peers.update(self.ban_manager.banned())
        else:
            self.peer_manager = None
            self.ban_manager = None
        self._shutting_down = False
        # pid8s whose gauges the last export_peer_gauges wrote — so a
        # disconnected peer's gauges can be zeroed instead of freezing
        self._exported_peer_gauges: Set[str] = set()
        # cross-peer signature-batch admission (ROADMAP 4 companion):
        # flooded SCP envelopes accumulate here within a crank and their
        # signatures verify as ONE batch through the fixed
        # SIG_BATCH_BUCKETS instead of per-envelope inside SCP
        self._scp_inbox: List = []
        self._scp_drain_posted = False
        self._sig_batching = bool(getattr(app.config,
                                          "OVERLAY_SIG_BATCH", True))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        pass  # TCP listen/connect wiring lives in tcp_peer.setup

    def shutdown(self) -> None:
        self._shutting_down = True
        for p in list(self.authenticated.values()):
            p.close("shutdown")

    def add_pending_peer(self, peer) -> None:
        self.pending_peers.append(peer)

    def peer_authenticated(self, peer) -> None:
        if peer.peer_id in self.banned_peers:
            peer.close("banned")
            return
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
        self.authenticated[peer.peer_id] = peer
        self.app.metrics.counter("overlay.connection.authenticated").inc()
        from ..utils.logging import get_logger

        get_logger("Overlay").info(
            "peer %s authenticated (%d connected)",
            peer.peer_id.hex()[:8], len(self.authenticated))
        addr = getattr(peer, "remote_addr", None)
        if addr is not None and self.peer_manager is not None:
            self.peer_manager.on_connect_success(*addr)
        # pull the peer's current consensus state immediately: without
        # this, a node whose first nomination fired before the connection
        # authenticated would never hear it and both sides could sit
        # silent forever (ref Peer.cpp sending GET_SCP_STATE on auth)
        seq = self.app.ledger_manager.last_closed_seq()
        peer.send_message(O.StellarMessage.make(
            O.MessageType.GET_SCP_STATE, seq))

    def peer_closed(self, peer, reason: str) -> None:
        if peer in self.pending_peers:
            self.pending_peers.remove(peer)
            # an outbound connection that dies before authenticating is a
            # connect failure for the peer DB's backoff accounting
            addr = getattr(peer, "remote_addr", None)
            if addr is not None and self.peer_manager is not None:
                self.peer_manager.on_connect_failure(*addr)
        if peer.peer_id and self.authenticated.get(peer.peer_id) is peer:
            del self.authenticated[peer.peer_id]
            # per-connection flood state dies with the connection: the
            # floodgate's have-sets and the tracker's per-link counters
            # restart fresh on re-dial, so churn cannot inflate the
            # dup-rate attribution or starve a reconnected peer of
            # re-floods (see Floodgate.forget_peer)
            self.floodgate.forget_peer(peer.peer_id)
            ft = getattr(self.app, "floodtracer", None)
            if ft is not None:
                ft.forget_link(peer.peer_id.hex()[:8])

    def connection_count(self) -> int:
        return len(self.authenticated)

    #: individually-exported peers in /metrics; the rest aggregate
    #: into one "other" bucket (bounded-cardinality discipline)
    PEER_VITALS_CAP = 16

    def peer_vitals(self, cap: Optional[int] = None) -> dict:
        """Per-peer overlay vitals, bounded: the first ``cap`` peers
        (stable id order) report individually, the remainder merge
        into an ``other`` roll-up so a 1000-peer node exports a
        constant-size payload."""
        cap = self.PEER_VITALS_CAP if cap is None else cap
        out: Dict[str, dict] = {}
        other = {"peers": 0, "queue_depth": 0, "unique_flood_recv": 0,
                 "duplicate_flood_recv": 0, "stale_scp_drops": 0,
                 "bytes_read": 0, "bytes_written": 0}
        for i, (pid, p) in enumerate(sorted(self.authenticated.items())):
            if i < cap:
                out[pid.hex()[:8]] = p.get_vitals()
                continue
            other["peers"] += 1
            other["queue_depth"] += len(p.outbound_queue)
            other["unique_flood_recv"] += p.unique_flood_recv
            other["duplicate_flood_recv"] += p.duplicate_flood_recv
            other["stale_scp_drops"] += p.stale_scp_drops
            other["bytes_read"] += p.bytes_read
            other["bytes_written"] += p.bytes_written
        if other["peers"]:
            out["other"] = other
        return out

    _PEER_GAUGE_KEYS = ("queue_depth", "unique_flood_recv",
                        "duplicate_flood_recv", "stale_scp_drops",
                        "bytes_read", "bytes_written")

    def export_peer_gauges(self) -> None:
        """Mirror the bounded per-peer vitals into the metrics registry
        (Prometheus exposition rides the registry).  Membership goes
        through ONE bounded_name family (``overlay.peer``) so all six
        gauge families stay in lockstep and peer churn cannot grow the
        registry past the cap: a churned-in peer past the cap folds
        into the ``other`` roll-up (instead of overwriting it), and a
        disconnected peer's gauges drop to zero on the next export
        (instead of freezing at their last values forever)."""
        m = self.app.metrics
        named: Dict[str, dict] = {}
        other = {k: 0.0 for k in self._PEER_GAUGE_KEYS}
        have_other = False
        for pid8, st in self.peer_vitals().items():
            if pid8 != "other" and not m.bounded_name(
                    "overlay.peer", pid8,
                    cap=self.PEER_VITALS_CAP).endswith(".other"):
                named[pid8] = st
                continue
            have_other = True
            for k in self._PEER_GAUGE_KEYS:
                other[k] += float(st.get(k, 0))
        for pid8 in self._exported_peer_gauges - set(named):
            for k in self._PEER_GAUGE_KEYS:
                m.gauge(f"overlay.peer.{k}.{pid8}").set(0.0)
        self._exported_peer_gauges = set(named)
        if have_other:
            named["other"] = other
        for pid8, st in named.items():
            for k in self._PEER_GAUGE_KEYS:
                m.gauge(f"overlay.peer.{k}.{pid8}").set(
                    float(st.get(k, 0)))

    def ban_peer(self, peer_id: bytes) -> None:
        self.banned_peers.add(peer_id)
        if self.ban_manager is not None:
            self.ban_manager.ban(peer_id)
        p = self.authenticated.get(peer_id)
        if p is not None:
            p.close("banned")

    def unban_peer(self, peer_id: bytes) -> None:
        self.banned_peers.discard(peer_id)
        if self.ban_manager is not None:
            self.ban_manager.unban(peer_id)

    # -- broadcast (the flood network) --------------------------------------

    def _ledger_seq(self) -> int:
        try:
            return self.app.ledger_manager.last_closed_seq()
        except Exception:
            return 0

    def broadcast_message(self, msg, force: bool = False,
                          _kind: Optional[str] = None,
                          _h: Optional[bytes] = None) -> None:
        """ref broadcastMessage :1038 — fan out to peers lacking it."""
        h = _h if _h is not None else Floodgate.msg_id(msg)
        ft = self.app.floodtracer
        if ft.enabled and _kind is not None and \
                h not in self.floodgate.records:
            # fresh locally-originated item (broadcast_transaction /
            # broadcast_scp before any flood record exists): hop zero
            ft.note_origin(h, _kind, self._ledger_seq())
        out = self.floodgate.peers_to_send(
            msg, list(self.authenticated.values()), h=h)
        if ft.enabled:
            ft.note_forward(h, len(out))
        for p in out:
            p.send_message(msg)

    def broadcast_transaction(self, env) -> None:
        self.broadcast_message(O.StellarMessage.make(
            O.MessageType.TRANSACTION, env), _kind="tx")

    def broadcast_scp(self, scp_env) -> None:
        self.broadcast_message(O.StellarMessage.make(
            O.MessageType.SCP_MESSAGE, scp_env), _kind="scp")

    # -- inbound dispatch (called from Peer) --------------------------------

    def _note_flood(self, peer, new: bool, h: bytes, kind: str,
                    seq: int) -> None:
        """Per-peer + aggregate flood-dedup attribution: which peer is
        feeding us fresh traffic vs redundant copies (the dedup hit
        rate the flood fan-out's efficiency shows up as)."""
        n = getattr(peer, "_last_frame_len", 0)
        if new:
            peer.unique_flood_recv += 1
            peer.unique_flood_bytes += n
            self.app.metrics.counter("overlay.flood.unique").inc()
        else:
            peer.duplicate_flood_recv += 1
            peer.duplicate_flood_bytes += n
            self.app.metrics.counter("overlay.flood.duplicate").inc()
        ft = self.app.floodtracer
        if ft.enabled:
            ft.note_recv(h, peer.peer_id.hex()[:8], new, kind, seq)

    def recv_transaction(self, peer, env) -> None:
        with self.app.tracer.span("overlay.recv.transaction"):
            # lifecycle stage "recv": stamp token captured BEFORE the
            # admission work so recv->admit covers decode+validity+sigs
            recv_ts = self.app.txtracer.note_recv()
            msg = O.StellarMessage.make(O.MessageType.TRANSACTION, env)
            h = Floodgate.msg_id(msg)
            seq = self._ledger_seq()
            new = self.floodgate.add_record(msg, peer.peer_id, seq, h=h)
            self._note_flood(peer, new, h, "tx", seq)
            if not new:
                return
            res = self.app.herder.tx_queue.try_add(env, recv_ts=recv_ts)
            if res == 0:  # pending: forward
                self.broadcast_message(msg, _h=h)

    def recv_scp_message(self, peer, scp_env) -> None:
        with self.app.tracer.span("overlay.recv.scp"):
            msg = O.StellarMessage.make(O.MessageType.SCP_MESSAGE,
                                        scp_env)
            h = Floodgate.msg_id(msg)
            seq = self._ledger_seq()
            new = self.floodgate.add_record(msg, peer.peer_id, seq, h=h)
            self._note_flood(peer, new, h, "scp", seq)
            if not new:
                return
            # per-peer stale attribution: which peer keeps feeding
            # out-of-bracket envelopes (the herder counts the discard
            # itself — this names the source)
            lo, hi = self.app.herder.scp_slot_bracket()
            if not lo <= scp_env.statement.slotIndex <= hi:
                peer.stale_scp_drops += 1
            if not self._sig_batching:
                self.app.herder.recv_scp_envelope(scp_env)
                self.broadcast_message(msg, _h=h)
                return
            # defer delivery to the end-of-crank drain so every peer's
            # envelopes this crank share one signature batch; forward
            # NOW (same as the direct path: forwarding never waited on
            # local verification)
            self._scp_inbox.append(scp_env)
            self.broadcast_message(msg, _h=h)
            if not self._scp_drain_posted:
                self._scp_drain_posted = True
                self.app.clock.post_action(self._drain_scp_inbox)

    def _drain_scp_inbox(self) -> None:
        """Batch-verify the crank's accumulated SCP envelope signatures
        (padded to the fixed SIG_BATCH_BUCKETS on the device tier), prime
        the herder driver's verdict cache, then deliver in arrival
        order — results identical to per-envelope verification, the
        device just sees one padded batch instead of N scalar calls."""
        self._scp_drain_posted = False
        batch, self._scp_inbox = self._scp_inbox, []
        if not batch or self._shutting_down:
            return
        herder = self.app.herder
        with self.app.tracer.span("overlay.recv.sigbatch",
                                  n_envs=len(batch)):
            # out-of-bracket envelopes get discarded unverified by the
            # herder — don't pay batch slots for them (a stale-replay
            # storm must not buy device work with dead envelopes)
            lo, hi = herder.scp_slot_bracket()
            triples = [herder.driver.envelope_sig_triple(env)
                       for env in batch
                       if lo <= env.statement.slotIndex <= hi]
            verdicts = self._verify_triples(triples)
            herder.driver.prime_sig_verdicts(zip(triples, verdicts))
            self.app.metrics.counter("overlay.sigbatch.batches").inc()
            self.app.metrics.counter("overlay.sigbatch.envelopes").inc(
                len(batch))
        for env in batch:
            herder.recv_scp_envelope(env)

    def _verify_triples(self, triples) -> List[bool]:
        """[(pub, sig, msg32)] -> verdicts; one padded batch on the node's
        device when it runs the CUDA crypto backend (a CUDA device
        launches the kernel of ops/ed25519_cuda or raises, a CPU device
        runs its plain torch version), the (process-cached) host
        chokepoint otherwise."""
        well_formed = all(len(t[0]) == 32 and len(t[1]) == 64
                          for t in triples)
        if self.app.config.CRYPTO_BACKEND == "cuda" and \
                len(triples) >= 2 and well_formed:
            import torch

            from ..ops.ed25519_cuda import verify_batch
            from ..utils.device import (default_device,
                                        padded_signature_batch,
                                        signature_columns)

            dev = default_device(self.app.device)
            # the device sees a small closed set of shapes: rows repeat
            # up to the SIG_BATCH_BUCKETS size
            ok = verify_batch(*(
                torch.from_numpy(a).to(dev) for a in
                padded_signature_batch(*signature_columns(triples))))
            return [bool(v) for v in ok[:len(triples)].cpu().numpy()]
        from ..crypto import verify_sig

        return [verify_sig(p, s, m) for p, s, m in triples]

    def recv_get_tx_set(self, peer, h: bytes) -> None:
        ts = self.app.herder.pending_envelopes.get_tx_set(h)
        if ts is not None:
            peer.send_message(O.StellarMessage.make(
                O.MessageType.TX_SET, ts.to_xdr()))
        else:
            peer.send_message(O.StellarMessage.make(
                O.MessageType.DONT_HAVE, O.DontHave.make(
                    type=O.MessageType.GET_TX_SET, reqHash=h)))

    def recv_tx_set(self, peer, xdr_tx_set) -> None:
        from ..herder.tx_set import TxSetFrame

        ts = TxSetFrame.make_from_wire(
            self.app.config.network_id(), xdr_tx_set)
        self.trackers.pop(ts.contents_hash(), None)
        self.app.herder.recv_tx_set(ts)

    def recv_get_qset(self, peer, h: bytes) -> None:
        qs = self.app.herder.pending_envelopes.get_qset(h)
        if qs is not None:
            peer.send_message(O.StellarMessage.make(
                O.MessageType.SCP_QUORUMSET, qs))
        else:
            peer.send_message(O.StellarMessage.make(
                O.MessageType.DONT_HAVE, O.DontHave.make(
                    type=O.MessageType.GET_SCP_QUORUMSET, reqHash=h)))

    def recv_qset(self, peer, qset) -> None:
        from ..scp.local_node import qset_hash

        self.trackers.pop(qset_hash(qset), None)
        self.app.herder.recv_qset(qset)

    def recv_get_scp_state(self, peer, ledger_seq: int) -> None:
        """ref HerderImpl::sendSCPStateToPeer: answer with the FULL
        remembered state (every node's latest envelopes) for slots the
        requester asked for — a rejoining node's direct peers are not
        v-blocking on sparse topologies, so self-only answers could
        never get it past its missed slots."""
        for slot_index in sorted(self.app.herder.scp.slots):
            if slot_index < ledger_seq:
                continue
            for env in self.app.herder.scp.get_current_state_envelopes(
                    slot_index):
                peer.send_message(O.StellarMessage.make(
                    O.MessageType.SCP_MESSAGE, env))

    def recv_dont_have(self, peer, dont_have) -> None:
        tracker = self.trackers.get(dont_have.reqHash)
        if tracker is not None:
            tracker.dont_have.add(peer.peer_id)
            self._ask_next(tracker)

    def recv_get_peers(self, peer) -> None:
        peer.send_message(O.StellarMessage.make(
            O.MessageType.PEERS, []))

    def recv_peers(self, peer, addrs) -> None:
        pass  # address book grows with the TCP transport

    def recv_flood_advert(self, peer, advert) -> None:
        """Pull-mode tx flooding: demand hashes we don't know
        (ref TxAdvertQueue.h:21)."""
        unknown = [h for h in advert.txHashes
                   if h not in self.app.herder.tx_queue.known]
        if unknown:
            peer.send_message(O.StellarMessage.make(
                O.MessageType.FLOOD_DEMAND,
                O.FloodDemand.make(txHashes=unknown)))

    def recv_flood_demand(self, peer, demand) -> None:
        for h in demand.txHashes:
            frame = self.app.herder.tx_queue.known.get(h)
            if frame is not None:
                peer.send_message(O.StellarMessage.make(
                    O.MessageType.TRANSACTION, frame.envelope))

    # -- anycast item fetch (ref ItemFetcher.h:54) ---------------------------

    # ref Tracker.h MS_TO_WAIT_FOR_FETCH_REPLY: how long to wait for a
    # fetch reply before asking the next peer.  Without the retry timer
    # one dropped request or reply wedges the tracker — and with it the
    # nomination waiting on the tx set — forever under lossy links (the
    # fault-schedule fuzzer found exactly that: flaky links + traffic
    # stalled a whole tiered network at one slot).
    FETCH_RETRY_S = 2.0
    # give up after this many retry firings (~1 virtual minute): a
    # tracker nobody can answer must not pin a timer forever — any
    # later envelope referencing the item starts a fresh fetch
    MAX_FETCH_RETRIES = 32

    def fetch_items(self, hashes: List[bytes]) -> None:
        for h in hashes:
            if h in self.trackers:
                continue
            # guess the type by asking for both; a txset-hash answered by
            # DONT_HAVE for one type will be retried as the other
            tracker = ItemTracker(h, O.MessageType.GET_TX_SET)
            self.trackers[h] = tracker
            self._ask_next(tracker)
            self._arm_fetch_retry(tracker)

    def _arm_fetch_retry(self, tracker: ItemTracker) -> None:
        """Re-ask for a still-missing item on a virtual-clock cadence
        (ref Tracker::tryNextPeer).  When every connected peer has been
        asked, the round-robin starts over — a peer that answered
        DONT_HAVE (or dropped the request) may have the item by now."""
        from ..utils.clock import VirtualTimer

        timer = VirtualTimer(self.app.clock, owner=self.app)
        timer.expires_from_now(self.FETCH_RETRY_S)

        def fire() -> None:
            if self._shutting_down or \
                    self.trackers.get(tracker.item_hash) is not tracker:
                return  # item arrived (or a fresh tracker took over)
            tracker.tries += 1
            if tracker.tries > self.MAX_FETCH_RETRIES:
                del self.trackers[tracker.item_hash]
                return
            if all(p.peer_id in tracker.asked
                   for p in self.authenticated.values()):
                tracker.asked.clear()
                tracker.dont_have.clear()
            self.app.metrics.counter("overlay.fetch.retry").inc()
            self._ask_next(tracker)
            self._arm_fetch_retry(tracker)

        timer.async_wait(fire)

    def _ask_next(self, tracker: ItemTracker) -> None:
        for p in self.authenticated.values():
            if p.peer_id in tracker.asked:
                continue
            tracker.asked.add(p.peer_id)
            p.send_message(O.StellarMessage.make(
                O.MessageType.GET_TX_SET, tracker.item_hash))
            p.send_message(O.StellarMessage.make(
                O.MessageType.GET_SCP_QUORUMSET, tracker.item_hash))
            return
