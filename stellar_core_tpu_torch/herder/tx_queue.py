"""TransactionQueue: the pre-consensus mempool, per source account, with
age/ban/shift lifecycle (ref src/herder/TransactionQueue.h:34-139).

Each account holds a seq-ordered chain of pending txs; entries age with
each ledger (shift) and are dropped at age limit; invalid/banned txs are
rejected with try-again-later semantics.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..ledger.ledger_txn import LedgerTxn
from ..transactions import TransactionFrame  # noqa: F401 (typing)
from ..transactions.frame import tx_frame_from_envelope
from ..transactions.frame import TC
from ..utils.tracing import stopwatch

#: the stages of ``try_add`` whose seconds it adds up between closes
ADMIT_STAGES = ("admit_frame", "admit_checks", "admit_queue")


class AccountTxs:
    __slots__ = ("frames", "age")

    def __init__(self):
        self.frames: List[TransactionFrame] = []
        self.age = 0


class TransactionQueue:
    ADD_STATUS_PENDING = 0
    ADD_STATUS_DUPLICATE = 1
    ADD_STATUS_ERROR = 2
    ADD_STATUS_TRY_AGAIN_LATER = 3
    ADD_STATUS_BANNED = 4

    PENDING_DEPTH = 4        # max age (ref pendingDepth)
    BAN_DEPTH = 10           # ledgers a banned tx stays banned
    MAX_PER_ACCOUNT = 112    # queue limit per account (v19 default ~)

    def __init__(self, app):
        self.app = app
        self.accounts: Dict[bytes, AccountTxs] = {}
        self.banned: List[set] = [set() for _ in range(self.BAN_DEPTH)]
        self.known: Dict[bytes, TransactionFrame] = {}
        self._ops_count = 0  # running total (capacity checks are O(1))
        # seconds in each admission stage since the herder last took them
        self._admit_s = dict.fromkeys(ADMIT_STAGES, 0.0)

    # -- admission ---------------------------------------------------------

    def try_add(self, env, recv_ts=None) -> int:
        """ref tryAdd :130 — the north-star admission path.

        ``recv_ts``: overlay-receive timestamp token (a value from
        ``app.txtracer.note_recv()``) so the lifecycle tracker's
        recv->admit delta covers the decode/validity/signature cost.

        Each stage's seconds add up in ``take_admit_stages``."""
        spent = self._admit_s
        with stopwatch() as sw:
            got = self._admit_frame(env)
        spent["admit_frame"] += sw.seconds
        if isinstance(got, int):
            return got
        frame, h = got
        with stopwatch() as sw:
            status = self._admit_checks(frame)
        spent["admit_checks"] += sw.seconds
        if status is not None:
            return status
        with stopwatch() as sw:
            status = self._admit_queue(frame, h, recv_ts)
        spent["admit_queue"] += sw.seconds
        return status

    def take_admit_stages(self) -> Dict[str, float]:
        """ms in each stage of ``try_add`` since the last take."""
        out = {k: v * 1000.0 for k, v in self._admit_s.items()}
        self._admit_s = dict.fromkeys(ADMIT_STAGES, 0.0)
        return out

    def _admit_frame(self, env):
        """The frame and its full hash, or the status that refuses it."""
        network_id = self.app.config.network_id()
        try:
            frame = tx_frame_from_envelope(network_id, env)
        except Exception:
            return self.ADD_STATUS_ERROR
        h = frame.full_hash()
        if h in self.known:
            return self.ADD_STATUS_DUPLICATE
        if any(h in b for b in self.banned):
            return self.ADD_STATUS_BANNED
        return frame, h

    def _admit_checks(self, frame) -> Optional[int]:
        """The account's room, its sequence chain and full validity (the
        signature check inside); None when the frame passes."""
        src = frame.source_account_id()
        acct = self.accounts.get(src)
        # cheap capacity check BEFORE the expensive validity/signature work
        if acct is not None and len(acct.frames) >= self.MAX_PER_ACCOUNT:
            return self.ADD_STATUS_TRY_AGAIN_LATER
        lm = self.app.ledger_manager

        # seq continuity: must extend the chain (account seq + queued txs)
        with LedgerTxn(lm.root) as ltx:
            entry = ltx.load_account(src)
            base_seq = entry.data.value.seqNum if entry else None
            expected = base_seq
            if acct is not None and acct.frames:
                expected = acct.frames[-1].seq_num()
            if base_seq is None:
                ltx.rollback()
                return self.ADD_STATUS_ERROR
            if frame.seq_num() != expected + 1:
                ltx.rollback()
                return self.ADD_STATUS_TRY_AGAIN_LATER
            # full validity, treating queued predecessors as applied
            res = frame.check_valid(ltx, current_seq=expected)
            ltx.rollback()
        if not res.ok:
            return self.ADD_STATUS_ERROR
        # stamp the verdict: TxSetFrame.make_from_transactions skips a
        # full re-check for frames validated against this same LCL (the
        # reference pays the re-check in C++; here it would dominate the
        # close trigger)
        frame.checked_valid_lcl = lm.last_closed_seq()
        return None

    def _admit_queue(self, frame, h: bytes, recv_ts) -> int:
        """Room in the queue, then the insert."""
        # global capacity: evict the cheapest tails, or reject the
        # newcomer if IT is the cheapest (ref TxQueueLimiter::canAddTx)
        if not self._make_room_for(frame):
            return self.ADD_STATUS_TRY_AGAIN_LATER

        src = frame.source_account_id()
        acct = self.accounts.get(src)
        if acct is None:
            acct = self.accounts[src] = AccountTxs()
        acct.frames.append(frame)
        self.known[h] = frame
        self._ops_count += frame.num_operations()
        self.app.metrics.counter("herder.pending-txs.count").inc()
        # lifecycle telemetry sampling gate (observational; the stamp's
        # wallclock read lives in utils/txtrace.py)
        self.app.txtracer.on_admit(h, recv_ts)
        return self.ADD_STATUS_PENDING

    # -- global size limiting (ref src/herder/TxQueueLimiter.h) ------------

    def _capacity_ops(self) -> int:
        return (self.app.config.TRANSACTION_QUEUE_SIZE_MULTIPLIER
                * self.app.ledger_manager.last_closed_header()
                .maxTxSetSize)

    @staticmethod
    def _fee_rate_lt(a, b) -> bool:
        """fee-per-op(a) < fee-per-op(b), exact cross-multiply."""
        return (a.fee_bid() * b.num_operations()
                < b.fee_bid() * a.num_operations())

    def _make_room_for(self, frame) -> bool:
        """Evict lowest-fee-rate account tails until the new tx fits;
        False (reject) when enough room cannot be freed from txs cheaper
        than the newcomer.  All-or-nothing: victims are only removed
        once the plan covers the shortfall, so a rejected newcomer never
        costs the queue anything.  The newcomer's own account chain is
        never broken.  Evicted txs are banned (BAN_DEPTH ledgers, same
        as age-outs) so their re-flood doesn't thrash the queue (ref
        TxQueueLimiter eviction + ban)."""
        cap = self._capacity_ops()
        shortfall = self._ops_count + frame.num_operations() - cap
        if shortfall <= 0:
            return True
        src = frame.source_account_id()
        tails = []  # planned victims, cheapest first, per-account tails
        depth: Dict[bytes, int] = {}
        # sorted once outside the planning loop (accounts don't change
        # until eviction below): victim ties must break by account id,
        # not by arrival/hash order (detlint det-unsorted-iter)
        accounts_by_id = sorted(self.accounts.items())
        while shortfall > 0:
            victim_src = None
            victim = None
            for vsrc, acct in accounts_by_id:
                if vsrc == src:
                    continue  # never break the newcomer's own chain
                idx = len(acct.frames) - 1 - depth.get(vsrc, 0)
                if idx < 0:
                    continue
                tail = acct.frames[idx]
                if victim is None or self._fee_rate_lt(tail, victim):
                    victim_src = vsrc
                    victim = tail
            if victim is None or not self._fee_rate_lt(victim, frame):
                return False  # can't free enough from cheaper txs
            tails.append((victim_src, victim))
            depth[victim_src] = depth.get(victim_src, 0) + 1
            shortfall -= victim.num_operations()
        for victim_src, victim in tails:
            self.accounts[victim_src].frames.pop()
            self.known.pop(victim.full_hash(), None)
            self.banned[0].add(victim.full_hash())
            self._ops_count -= victim.num_operations()
            self.app.metrics.counter("herder.pending-txs.count").dec()
        return True

    # -- harvesting --------------------------------------------------------

    def get_transactions(self) -> List[TransactionFrame]:
        out: List[TransactionFrame] = []
        for acct in self.accounts.values():
            out.extend(acct.frames)
        return out

    # -- lifecycle ---------------------------------------------------------

    def shift(self, ltx_root) -> None:
        """Post-close: drop applied/invalidated txs, age the rest, ban
        expired ones (ref shift :139 + removeApplied)."""
        self.banned.pop()
        self.banned.insert(0, set())
        with LedgerTxn(ltx_root) as ltx:
            for src in list(self.accounts):
                acct = self.accounts[src]
                entry = ltx.load_account(src)
                seq = entry.data.value.seqNum if entry else -1
                kept = [f for f in acct.frames if f.seq_num() > seq]
                dropped = [f for f in acct.frames if f.seq_num() <= seq]
                for f in dropped:
                    self.known.pop(f.full_hash(), None)
                acct.frames = kept
                if dropped:
                    acct.age = 0  # account made progress
                else:
                    acct.age += 1
                if acct.age >= self.PENDING_DEPTH:
                    for f in acct.frames:
                        self.known.pop(f.full_hash(), None)
                        self.banned[0].add(f.full_hash())
                    acct.frames = []
                if not acct.frames:
                    if acct.age >= self.PENDING_DEPTH or not kept:
                        self.accounts.pop(src, None)
            ltx.rollback()
        self._ops_count = sum(f.num_operations()
                              for acct in self.accounts.values()
                              for f in acct.frames)
        self.app.metrics.counter("herder.pending-txs.count").set_count(
            len(self.known))

    def is_banned(self, tx_hash: bytes) -> bool:
        return any(tx_hash in b for b in self.banned)

    def size(self) -> int:
        return len(self.known)
