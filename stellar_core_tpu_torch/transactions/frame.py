"""TransactionFrame: hashing, fees, the validity-check chain, sequence
numbers, signature gathering, and the all-or-nothing apply loop over
operations (ref src/transactions/TransactionFrame.cpp — SURVEY.md §2.5).

The north-star hot path lives here: checkValid -> commonValid ->
processSignatures -> SignatureChecker.checkSignature -> crypto verify
(ref TransactionFrame.cpp:1339, SecretKey.cpp:428).  The verify callable is
pluggable so the Herder can pre-verify whole TxSets with the batched TPU
kernel and feed cached verdicts here (the --crypto-backend seam).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..crypto import sha256
from ..ledger.ledger_txn import LedgerTxn
from ..xdr import types as T
from . import utils as U
from .operations import make_operation_frame
from .signature_checker import SignatureChecker, account_signers

TC = T.TransactionResultCode

# OperationType value -> lowercase name ("payment", "manage_sell_offer")
# for the flight recorder's per-op-type apply cost attribution
_OP_TYPE_NAMES = {
    getattr(T.OperationType, n): n.lower()
    for n in dir(T.OperationType)
    if not n.startswith("_")
    and isinstance(getattr(T.OperationType, n), int)
}


def op_type_name(op_type: int) -> str:
    return _OP_TYPE_NAMES.get(op_type, f"op_{op_type}")

# ref TransactionFrame.h ValidationType: how far commonValid got — at
# apply, cv >= kInvalidUpdateSeqNum still consumes the sequence number
VT_INVALID = 0            # kInvalid
VT_INVALID_UPD_SEQ = 1    # kInvalidUpdateSeqNum
VT_INVALID_POST_AUTH = 2  # kInvalidPostAuth
VT_MAYBE_VALID = 3        # kMaybeValid


def _op_default_success(opf) -> object:
    """The default-initialized opINNER result the reference gives ops whose
    signatures passed in a tx failed by a sibling op's bad auth
    (ref OperationFrame::resetResultSuccess + markResultFailed)."""
    op_type = opf.op.body.type
    return T.OperationResult.make(
        T.OperationResultCode.opINNER,
        T.OperationResultTr.default_for(op_type))


class ValidationResult:
    def __init__(self, code: int, fee_charged: int = 0):
        self.code = code
        self.fee_charged = fee_charged

    @property
    def ok(self) -> bool:
        return self.code == TC.txSUCCESS


class TransactionFrame:
    def __init__(self, network_id: bytes, envelope):
        if envelope.type == T.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            raise ValueError("use FeeBumpTransactionFrame")
        self.network_id = network_id
        self.envelope = envelope
        if envelope.type == T.EnvelopeType.ENVELOPE_TYPE_TX_V0:
            v0tx = envelope.value.tx
            # normalize v0 -> v1 view (ref: TransactionV0 parsed as v1)
            self.tx = T.Transaction.make(
                sourceAccount=T.MuxedAccount.make(
                    T.CryptoKeyType.KEY_TYPE_ED25519,
                    v0tx.sourceAccountEd25519),
                fee=v0tx.fee,
                seqNum=v0tx.seqNum,
                cond=(T.Preconditions.make(T.PreconditionType.PRECOND_NONE)
                      if v0tx.timeBounds is None else
                      T.Preconditions.make(T.PreconditionType.PRECOND_TIME,
                                           v0tx.timeBounds)),
                memo=v0tx.memo,
                operations=v0tx.operations,
                ext=T.Transaction.fields[6][1].make(0),
            )
        else:
            self.tx = envelope.value.tx
        self.signatures = list(envelope.value.signatures)
        self._hash: Optional[bytes] = None
        self.op_frames = [
            make_operation_frame(op, self) for op in self.tx.operations]
        self.result_code: int = TC.txSUCCESS
        self.fee_charged: int = 0

    # -- identity ----------------------------------------------------------

    def source_account_id(self) -> bytes:
        return U.muxed_to_account_id(self.tx.sourceAccount)

    def seq_num(self) -> int:
        return self.tx.seqNum

    def keys_to_prefetch(self) -> list:
        """Encoded LedgerKeys this tx will likely touch — source accounts
        plus per-op obvious targets (ref insertKeysForFeeProcessing +
        insertLedgerKeysToPrefetch; best-effort, misses only cost a later
        point lookup)."""
        from ..ledger.ledger_txn import account_key, key_bytes, \
            trustline_key

        OT = T.OperationType
        keys = set()

        def acct(aid: bytes):
            keys.add(key_bytes(account_key(aid)))

        def tl(aid: bytes, asset):
            if U.is_native(asset):
                return
            keys.add(key_bytes(trustline_key(
                aid, U.to_trustline_asset(asset))))

        acct(self.source_account_id())
        for opf in self.op_frames:
            src = opf.source_account_id()
            acct(src)
            b = opf.body
            t = opf.op.body.type
            if t == OT.CREATE_ACCOUNT:
                acct(b.destination.value)
            elif t == OT.PAYMENT:
                dest = U.muxed_to_account_id(b.destination)
                acct(dest)
                tl(src, b.asset)
                tl(dest, b.asset)
            elif t in (OT.PATH_PAYMENT_STRICT_RECEIVE,
                       OT.PATH_PAYMENT_STRICT_SEND):
                dest = U.muxed_to_account_id(b.destination)
                acct(dest)
                tl(src, b.sendAsset)
                tl(dest, b.destAsset)
            elif t == OT.ACCOUNT_MERGE:
                acct(U.muxed_to_account_id(b))
            elif t == OT.CHANGE_TRUST:
                if b.line.type != T.AssetType.ASSET_TYPE_POOL_SHARE:
                    tl(src, T.Asset.make(b.line.type, b.line.value))
            elif t in (OT.MANAGE_SELL_OFFER, OT.MANAGE_BUY_OFFER,
                       OT.CREATE_PASSIVE_SELL_OFFER):
                tl(src, b.selling)
                tl(src, b.buying)
        return list(keys)

    def full_hash(self) -> bytes:
        """sha256 of the TransactionSignaturePayload — what gets signed AND
        the tx id (ref TransactionFrame::getContentsHash)."""
        if self._hash is None:
            payload = T.TransactionSignaturePayload.make(
                networkId=self.network_id,
                taggedTransaction=T.TransactionSignaturePayload.fields[1][1]
                .make(T.EnvelopeType.ENVELOPE_TYPE_TX, self.tx),
            )
            self._hash = sha256(
                T.TransactionSignaturePayload.encode(payload))
        return self._hash

    def num_operations(self) -> int:
        return len(self.tx.operations)

    # -- preconditions -----------------------------------------------------

    def _time_bounds(self):
        c = self.tx.cond
        if c.type == T.PreconditionType.PRECOND_TIME:
            return c.value
        if c.type == T.PreconditionType.PRECOND_V2:
            return c.value.timeBounds
        return None

    def _ledger_bounds(self):
        c = self.tx.cond
        if c.type == T.PreconditionType.PRECOND_V2:
            return c.value.ledgerBounds
        return None

    def _v2(self):
        c = self.tx.cond
        return c.value if c.type == T.PreconditionType.PRECOND_V2 else None

    def is_too_early(self, header, lower_bound_close_time_offset=0) -> bool:
        tb = self._time_bounds()
        if tb is not None and tb.minTime:
            close_time = header.scpValue.closeTime
            if close_time + lower_bound_close_time_offset < tb.minTime:
                return True
        lb = self._ledger_bounds()
        if lb is not None and lb.minLedger > header.ledgerSeq:
            return True
        return False

    def is_too_late(self, header, upper_bound_close_time_offset=0) -> bool:
        tb = self._time_bounds()
        if tb is not None and tb.maxTime:
            close_time = header.scpValue.closeTime
            if close_time - upper_bound_close_time_offset > tb.maxTime:
                return True
        lb = self._ledger_bounds()
        if lb is not None and lb.maxLedger and \
                lb.maxLedger <= header.ledgerSeq:
            return True
        return False

    # -- fees --------------------------------------------------------------

    def get_full_fee(self) -> int:
        return self.tx.fee

    def get_inclusion_fee(self) -> int:
        return self.tx.fee

    def get_min_fee(self, header) -> int:
        return max(1, self.num_operations()) * header.baseFee

    def fee_bid(self) -> int:
        return self.tx.fee

    # -- the validity chain ------------------------------------------------

    def common_valid_pre_seqnum(self, ltx, charge_fee: bool,
                                current: bool = False) -> int:
        """ref commonValidPreSeqNum (TransactionFrame.cpp:849)."""
        header = ltx.header()
        if not self.tx.operations:
            return TC.txMISSING_OPERATION
        if len(self.tx.operations) > U.TX_MAX_OPS:
            return TC.txMALFORMED
        tb = self._time_bounds()
        if tb is not None and tb.maxTime and tb.minTime > tb.maxTime:
            return TC.txMALFORMED
        v2 = self._v2()
        if v2 is not None:
            lb = v2.ledgerBounds
            if lb is not None and lb.maxLedger and \
                    lb.minLedger > lb.maxLedger:
                return TC.txMALFORMED
            if v2.minSeqNum is not None and v2.minSeqNum < 0:
                return TC.txMALFORMED
        if self.is_too_early(header):
            return TC.txTOO_EARLY
        if self.is_too_late(header):
            return TC.txTOO_LATE
        if charge_fee and self.get_inclusion_fee() < \
                self.get_min_fee(header):
            return TC.txINSUFFICIENT_FEE
        if self.fee_bid() < 0:
            return TC.txMALFORMED
        if ltx.load_account(self.source_account_id()) is None:
            return TC.txNO_ACCOUNT
        return TC.txSUCCESS

    def _check_seq_num(self, acc, header, current_seq: int = 0) -> bool:
        """ref isBadSeq: normally tx.seqNum == acc.seqNum + 1; with
        PreconditionsV2.minSeqNum the window [minSeqNum, tx.seqNum) is
        allowed.  ``current_seq`` (ref checkValid's 'current' arg) overrides
        the account seq when validating chained txs in a candidate set."""
        if self.tx.seqNum < 0:
            return False
        # starting seqnum of a new account in this ledger cannot collide
        starting = (header.ledgerSeq << 32)
        if self.tx.seqNum == starting:
            return False
        base = current_seq if current_seq else acc.seqNum
        v2 = self._v2()
        if v2 is not None and v2.minSeqNum is not None:
            return v2.minSeqNum <= base < self.tx.seqNum
        return base + 1 == self.tx.seqNum

    def _is_too_early_for_account(self, header, acc) -> bool:
        """PreconditionsV2 minSeqAge / minSeqLedgerGap vs the account's
        stamped seqTime/seqLedger (ref isTooEarlyForAccount :805 —
        protocol >= 19, checked in BOTH validate and apply modes)."""
        v2 = self._v2()
        if v2 is None:
            return False
        if v2.minSeqAge:
            close_time = header.scpValue.closeTime
            if v2.minSeqAge > close_time or \
                    close_time - v2.minSeqAge < U.seq_time(acc):
                return True
        if v2.minSeqLedgerGap:
            if v2.minSeqLedgerGap > header.ledgerSeq or \
                    header.ledgerSeq - v2.minSeqLedgerGap < \
                    U.seq_ledger(acc):
                return True
        return False

    def common_valid(self, ltx, checker: SignatureChecker, applying: bool,
                     charge_fee: bool,
                     current_seq: int = 0) -> Tuple[int, int]:
        """ref commonValid (TransactionFrame.cpp:1104-1192).  Returns
        ``(tier, code)`` where ``tier`` is the reference's ValidationType —
        it decides whether a failing tx still consumes its sequence number
        at apply (cv >= kInvalidUpdateSeqNum does; ref apply :1770-1772):

          VT_INVALID          pre-seqnum failure or bad seq (no consume)
          VT_INVALID_UPD_SEQ  too-early-for-account / bad auth
          VT_INVALID_POST_AUTH insufficient balance
          VT_MAYBE_VALID      all checks passed

        The check ORDER matters for result-code parity: seq -> seq-age ->
        tx-level auth -> extra signers -> balance."""
        res = self.common_valid_pre_seqnum(ltx, charge_fee)
        if res != TC.txSUCCESS:
            return VT_INVALID, res
        header = ltx.header()
        entry = ltx.load_account(self.source_account_id())
        acc = entry.data.value
        # bad-seq is re-checked when applying too (ref :1135-1148 — at
        # protocol >= 10 the seqnum is consumed during apply, not at the
        # fee phase, so the account seq is still the pre-tx value here; an
        # earlier tx in the set may have bumped it past ours)
        if not self._check_seq_num(acc, header, current_seq):
            return VT_INVALID, TC.txBAD_SEQ
        if self._is_too_early_for_account(header, acc):
            return VT_INVALID_UPD_SEQ, TC.txBAD_MIN_SEQ_AGE_OR_GAP
        needed = U.threshold(acc, U.ThresholdLevel.LOW)
        if not checker.check_signature(account_signers(acc),
                                       max(needed, 1)):
            return VT_INVALID_UPD_SEQ, TC.txBAD_AUTH
        v2 = self._v2()
        if v2 is not None:
            for skey in v2.extraSigners:
                if not checker.check_signature([(skey, 1)], 1):
                    return VT_INVALID_UPD_SEQ, TC.txBAD_AUTH
        if charge_fee:
            # fee must be payable above the reserve; when applying the fee
            # was already deducted at the fee phase, so only require the
            # account not be below reserve+liabilities (ref feeToPay=0
            # :1178-1190)
            fee_to_pay = 0 if applying else self.get_full_fee()
            _, selling = U.account_liabilities(acc)
            available = (acc.balance - selling
                         - U.min_balance(header, acc))
            if available < fee_to_pay:
                return VT_INVALID_POST_AUTH, TC.txINSUFFICIENT_BALANCE
        return VT_MAYBE_VALID, TC.txSUCCESS

    def check_valid(self, ltx_parent, current_seq: int = 0,
                    verify: Optional[Callable] = None,
                    charge_fee: bool = True) -> ValidationResult:
        """Full admission-time validity (ref checkValid :1339): structure,
        preconditions, fee, seqnum, signatures for the tx AND every op.
        Read-only — runs in a throwaway LedgerTxn.  ``current_seq``
        validates a tx whose predecessors (consuming seqs up to that value)
        are already in the candidate set.  ``charge_fee=False`` is the
        fee-bump inner-tx mode (ref checkValidWithOptionallyChargedFee)."""
        with LedgerTxn(ltx_parent) as ltx:
            checker = SignatureChecker(
                self.full_hash(), self.signatures, verify)
            tier, res = self.common_valid(ltx, checker, applying=False,
                                          charge_fee=charge_fee,
                                          current_seq=current_seq)
            if tier != VT_MAYBE_VALID:
                self.result_code = res
                ltx.rollback()
                return ValidationResult(res)
            for opf in self.op_frames:
                if not opf.check_signatures(ltx, checker):
                    self.result_code = TC.txFAILED
                    ltx.rollback()
                    return ValidationResult(TC.txFAILED)
                if not opf.check_valid(ltx.header()):
                    self.result_code = TC.txFAILED
                    ltx.rollback()
                    return ValidationResult(TC.txFAILED)
            if not checker.check_all_signatures_used():
                self.result_code = TC.txBAD_AUTH_EXTRA
                ltx.rollback()
                return ValidationResult(TC.txBAD_AUTH_EXTRA)
            ltx.rollback()
        self.result_code = TC.txSUCCESS
        return ValidationResult(TC.txSUCCESS)

    # -- fee + seqnum processing (ledger close phase 1) ---------------------

    def process_fee_seq_num(self, ltx, base_fee: Optional[int]) -> object:
        """Charge the fee (ref processFeeSeqNum :1196 — at protocol >= 10
        the sequence number is consumed during apply, not here; this
        framework is protocol-19-only).  Returns the fee-phase
        LedgerEntryChanges (the TransactionResultMeta.feeProcessing)."""
        header = ltx.header()
        fee = self.get_full_fee() if base_fee is None else min(
            self.get_full_fee(),
            base_fee * max(1, self.num_operations()))
        with LedgerTxn(ltx) as inner:
            entry = inner.load_account(self.source_account_id())
            if entry is None:
                raise RuntimeError("fee source vanished")
            acc = entry.data.value
            charged = min(fee, acc.balance)
            self.fee_charged = charged
            acc = U.add_balance(acc, -charged)
            hdr = header._replace(feePool=header.feePool + charged)
            inner.set_header(hdr)
            inner.put(entry._replace(data=T.LedgerEntryData.make(
                T.LedgerEntryType.ACCOUNT, acc)))
            changes = inner.changes()
            inner.commit()
        return changes

    def _process_seq_num(self, ltx) -> None:
        """Consume the sequence number + stamp seqLedger/seqTime (v3 ext)
        (ref processSeqNum :1003 + maybeUpdateAccountOnLedgerSeqUpdate)."""
        header = ltx.header()
        entry = ltx.load_account(self.source_account_id())
        acc = entry.data.value
        if acc.seqNum > self.tx.seqNum:
            raise RuntimeError("unexpected sequence number")
        acc = U.set_seq_info(acc, self.tx.seqNum, header.ledgerSeq,
                             header.scpValue.closeTime)
        ltx.put(entry._replace(data=T.LedgerEntryData.make(
            T.LedgerEntryType.ACCOUNT, acc)))

    def _remove_one_time_signers(self, ltx) -> None:
        """Remove this tx's pre-auth-tx signer from every source account
        (ref removeOneTimeSignerFromAllSourceAccounts :1239 — runs during
        apply whether or not the tx succeeds)."""
        from . import sponsorship as SP

        skey = T.SignerKey.make(
            T.SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX, self.full_hash())
        skey_b = T.SignerKey.encode(skey)
        accounts = {self.source_account_id()}
        for opf in self.op_frames:
            accounts.add(opf.source_account_id())
        for aid in sorted(accounts):
            entry = ltx.load_account(aid)
            if entry is None:
                continue  # removed by an earlier merge
            acc = entry.data.value
            signers = list(acc.signers)
            idx = next((i for i, s in enumerate(signers)
                        if T.SignerKey.encode(s.key) == skey_b), None)
            if idx is None:
                continue
            sids = SP.signer_sponsoring_ids(acc)
            old_sponsor = sids[idx].value if sids[idx] is not None else None
            SP.release_signer_sponsorship(ltx, old_sponsor)
            if old_sponsor is not None:
                acc = SP.add_num_sponsored(acc, -1)
            signers.pop(idx)
            sids.pop(idx)
            acc = acc._replace(numSubEntries=acc.numSubEntries - 1,
                               signers=signers)
            if any(s is not None for s in sids) or (
                    acc.ext.type == 1 and acc.ext.value.ext.type == 2):
                acc = SP.set_signer_sponsoring_ids(acc, sids)
            ltx.put(entry._replace(data=T.LedgerEntryData.make(
                T.LedgerEntryType.ACCOUNT, acc)))

    # -- apply (ledger close phase 2) --------------------------------------

    def apply(self, ltx, verify: Optional[Callable] = None,
              invariant_check: Optional[Callable] = None,
              charge_fee: bool = True) -> Tuple[bool, object, object]:
        """Apply (ref apply :1752 / applyOperations :1388).  Returns
        (success, TransactionResult, TransactionMeta-v2-value).

        Structure mirrors the reference's two-phase apply: a pre-ops
        LedgerTxn consumes the sequence number (unless validation failed
        before the seq stage — ref cv >= kInvalidUpdateSeqNum), runs
        signature processing, and removes used pre-auth-tx signers; its
        delta becomes the meta's txChangesBefore and COMMITS even when
        the tx fails (a failed tx still burns its seqnum).  Operations
        then apply all-or-nothing in their own layer.

        ``invariant_check(op_ltx, op_frame, ok)`` runs against each
        OPERATION's isolated delta before its commit (ref
        InvariantManager::checkOnOperationApply from
        TransactionFrame.cpp:1441)."""
        checker = SignatureChecker(self.full_hash(), self.signatures, verify)
        with LedgerTxn(ltx) as pre_ltx:
            # charge_fee=False is the fee-bump inner-tx path (ref
            # FeeBumpTransactionFrame::apply -> mInnerTx->apply with
            # chargeFee=false): the outer tx paid, so the inner skips
            # min-fee and balance checks at apply
            tier, res = self.common_valid(pre_ltx, checker, applying=True,
                                          charge_fee=charge_fee)
            # a failing tx still consumes its seqnum unless validation
            # failed at or before the seq stage (ref apply :1770-1772:
            # cv >= kInvalidUpdateSeqNum -> processSeqNum)
            if tier >= VT_INVALID_UPD_SEQ:
                self._process_seq_num(pre_ltx)
            ops_sig_results: Optional[List[object]] = None
            if tier == VT_MAYBE_VALID:
                # op-level signature pre-check in a throwaway layer (ref
                # processSignatures' allOpsValid loop :1049); only ops
                # that actually fail are marked opBAD_AUTH — passing ops
                # keep the default-initialized opINNER success result
                # (ref OperationFrame::checkSignature :194 + markResultFailed)
                # read-only probe (ref scopes a throwaway LedgerTxn; our
                # check_signatures never writes, so probe pre_ltx direct)
                failed = [not opf.check_signatures(pre_ltx, checker)
                          for opf in self.op_frames]
                if any(failed):
                    res = TC.txFAILED
                    ops_sig_results = [
                        T.OperationResult.make(
                            T.OperationResultCode.opBAD_AUTH)
                        if bad else _op_default_success(opf)
                        for bad, opf in zip(failed, self.op_frames)]
                elif not checker.check_all_signatures_used():
                    res = TC.txBAD_AUTH_EXTRA
            self._remove_one_time_signers(pre_ltx)
            changes_before = pre_ltx.changes()
            pre_ltx.commit()

        if res != TC.txSUCCESS:
            self.result_code = res
            return (False,
                    self._make_result(res, ops_sig_results or []),
                    _meta([], changes_before))

        # per-op-type cost attribution: active only inside a close's
        # apply phase (LedgerManager installs the collector); the
        # disabled path costs one thread-local read per transaction
        from ..utils import tracing

        op_costs = tracing.op_collector()
        with LedgerTxn(ltx) as tx_ltx:
            op_results: List[object] = []
            op_metas: List[object] = []
            success = True
            for opf in self.op_frames:
                with LedgerTxn(tx_ltx) as op_ltx:
                    if op_costs is None:
                        ok = opf.apply(op_ltx, checker)
                    else:
                        with tracing.stopwatch() as sw:
                            ok = opf.apply(op_ltx, checker)
                        op_costs.add(op_type_name(opf.op.body.type),
                                     sw.seconds)
                    if ok:
                        if invariant_check is not None:
                            invariant_check(op_ltx, opf, True)
                        op_metas.append(T.OperationMeta.make(
                            changes=op_ltx.changes()))
                        op_ltx.commit()
                    else:
                        op_ltx.rollback()
                        success = False
                op_results.append(opf.result)
                if not success:
                    break
            if success:
                # every BEGIN_SPONSORING_FUTURE_RESERVES must be closed by
                # tx end (ref TransactionFrame applyOperations ->
                # txBAD_SPONSORSHIP)
                from .sponsorship import any_active_sponsorships

                if any_active_sponsorships(tx_ltx):
                    success = False
                    self.result_code = TC.txBAD_SPONSORSHIP
                    tx_ltx.rollback()
                    return (False,
                            self._make_result(TC.txBAD_SPONSORSHIP, []),
                            _meta([], changes_before))
            if success:
                tx_ltx.commit()
                self.result_code = TC.txSUCCESS
                return (True,
                        self._make_result(TC.txSUCCESS, op_results),
                        _meta(op_metas, changes_before))
            # failed: fill results for remaining unapplied ops
            while len(op_results) < len(self.op_frames):
                idx = len(op_results)
                opf = self.op_frames[idx]
                op_results.append(
                    opf.result if opf.result is not None else
                    T.OperationResult.make(
                        T.OperationResultCode.opNOT_SUPPORTED))
            tx_ltx.rollback()
            self.result_code = TC.txFAILED
            return (False, self._make_result(TC.txFAILED, op_results),
                    _meta([], changes_before))

    def _make_result(self, code: int, op_results: List[object]) -> object:
        if code in (TC.txSUCCESS, TC.txFAILED):
            inner = T.TransactionResult.fields[1][1].make(code, op_results)
        else:
            inner = T.TransactionResult.fields[1][1].make(code)
        return T.TransactionResult.make(
            feeCharged=self.fee_charged,
            result=inner,
            ext=T.TransactionResult.fields[2][1].make(0),
        )

    def result_pair(self, result) -> object:
        return T.TransactionResultPair.make(
            transactionHash=self.full_hash(), result=result)


def _meta(op_metas: List[object], changes_before=()) -> object:
    return T.TransactionMeta.make(2, T.TransactionMetaV2.make(
        txChangesBefore=list(changes_before), operations=op_metas,
        txChangesAfter=[]))


def _empty_meta() -> object:
    return _meta([])


def tx_frame_from_envelope(network_id: bytes, envelope):
    """Envelope -> frame (fee-bump aware)."""
    if envelope.type == T.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
        from .fee_bump import FeeBumpTransactionFrame

        return FeeBumpTransactionFrame(network_id, envelope)
    return TransactionFrame(network_id, envelope)
