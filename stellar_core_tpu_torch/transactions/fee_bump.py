"""FeeBumpTransactionFrame: the outer fee-bump envelope semantics
(ref src/transactions/FeeBumpTransactionFrame.cpp, 525 LoC).

A fee bump wraps an inner v1 transaction: an unrelated fee source pays a
(higher) fee on the inner tx's behalf.  The inner tx keeps its own hash,
sequence number, and signatures; the outer envelope adds only feeSource,
fee, and the fee source's signatures.  Results are reported as
txFEE_BUMP_INNER_{SUCCESS,FAILED} wrapping an InnerTransactionResultPair.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..crypto import sha256
from ..ledger.ledger_txn import LedgerTxn
from ..xdr import types as T
from . import utils as U
from .frame import TransactionFrame, ValidationResult
from .signature_checker import SignatureChecker, account_signers

TC = T.TransactionResultCode


class FeeBumpTransactionFrame:
    def __init__(self, network_id: bytes, envelope):
        assert envelope.type == T.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP
        self.network_id = network_id
        self.envelope = envelope
        self.fee_bump_tx = envelope.value.tx  # FeeBumpTransaction
        self.signatures = list(envelope.value.signatures)
        inner_env = T.TransactionEnvelope.make(
            T.EnvelopeType.ENVELOPE_TYPE_TX, self.fee_bump_tx.innerTx.value)
        self.inner_tx = TransactionFrame(network_id, inner_env)
        self._hash: Optional[bytes] = None
        self.result_code: int = TC.txSUCCESS
        self.fee_charged: int = 0
        # herder-facing aliases used where TransactionFrame is expected
        self.op_frames = self.inner_tx.op_frames

    # -- identity ----------------------------------------------------------

    def fee_source_id(self) -> bytes:
        return U.muxed_to_account_id(self.fee_bump_tx.feeSource)

    def keys_to_prefetch(self) -> list:
        from ..ledger.ledger_txn import account_key, key_bytes

        return [key_bytes(account_key(self.fee_source_id()))] + \
            self.inner_tx.keys_to_prefetch()

    # the "source account" for queue/seqnum purposes is the INNER source
    def source_account_id(self) -> bytes:
        return self.inner_tx.source_account_id()

    def seq_num(self) -> int:
        return self.inner_tx.seq_num()

    def full_hash(self) -> bytes:
        """Hash of the ENVELOPE_TYPE_TX_FEE_BUMP signature payload — the
        outer tx id (ref FeeBumpTransactionFrame::getContentsHash)."""
        if self._hash is None:
            payload = T.TransactionSignaturePayload.make(
                networkId=self.network_id,
                taggedTransaction=T.TransactionSignaturePayload.fields[1][1]
                .make(T.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
                      self.fee_bump_tx))
            self._hash = sha256(
                T.TransactionSignaturePayload.encode(payload))
        return self._hash

    def inner_hash(self) -> bytes:
        return self.inner_tx.full_hash()

    def num_operations(self) -> int:
        """ops + 1: the bump itself counts one op toward fees
        (ref getNumOperations)."""
        return self.inner_tx.num_operations() + 1

    # -- fees --------------------------------------------------------------

    def fee_bid(self) -> int:
        return self.fee_bump_tx.fee

    def get_full_fee(self) -> int:
        return self.fee_bump_tx.fee

    def get_inclusion_fee(self) -> int:
        return self.fee_bump_tx.fee

    def get_min_fee(self, header) -> int:
        return self.num_operations() * header.baseFee

    # -- validity ----------------------------------------------------------

    def _common_valid_pre(self, ltx) -> int:
        """ref commonValidPreSeqNum (FeeBumpTransactionFrame.cpp:222)."""
        header = ltx.header()
        if self.fee_bid() < 0:
            return TC.txMALFORMED
        if self.fee_bid() < self.get_min_fee(header):
            return TC.txINSUFFICIENT_FEE
        # fee-rate dominance: feeBid * minFee(inner) >= innerBid *
        # minFee(outer) (ref :242-243)
        inner_min = self.inner_tx.get_min_fee(header)
        if self.fee_bid() * inner_min < \
                self.inner_tx.fee_bid() * self.get_min_fee(header):
            return TC.txINSUFFICIENT_FEE
        if ltx.load_account(self.fee_source_id()) is None:
            return TC.txNO_ACCOUNT
        return TC.txSUCCESS

    def _check_fee_source_auth(self, ltx, checker) -> bool:
        entry = ltx.load_account(self.fee_source_id())
        acc = entry.data.value
        needed = U.threshold(acc, U.ThresholdLevel.LOW)
        return checker.check_signature(account_signers(acc), max(needed, 1))

    def check_valid(self, ltx_parent, current_seq: int = 0,
                    verify: Optional[Callable] = None) -> ValidationResult:
        """ref checkValid (:185): outer commonValid + signatures, then the
        inner tx's full checkValid with charge_fee=False (the outer source
        pays)."""
        with LedgerTxn(ltx_parent) as ltx:
            checker = SignatureChecker(
                self.full_hash(), self.signatures, verify)
            res = self._common_valid_pre(ltx)
            if res == TC.txSUCCESS:
                if not self._check_fee_source_auth(ltx, checker):
                    res = TC.txBAD_AUTH
            if res == TC.txSUCCESS:
                header = ltx.header()
                entry = ltx.load_account(self.fee_source_id())
                acc = entry.data.value
                if U.get_available_balance(header, acc) < \
                        self.get_full_fee():
                    res = TC.txINSUFFICIENT_BALANCE
            if res == TC.txSUCCESS and \
                    not checker.check_all_signatures_used():
                res = TC.txBAD_AUTH_EXTRA
            ltx.rollback()
        if res != TC.txSUCCESS:
            self.result_code = res
            return ValidationResult(res)
        inner_res = self.inner_tx.check_valid(
            ltx_parent, current_seq=current_seq, verify=verify,
            charge_fee=False)
        if not inner_res.ok:
            self.result_code = TC.txFEE_BUMP_INNER_FAILED
            return ValidationResult(TC.txFEE_BUMP_INNER_FAILED)
        self.result_code = TC.txSUCCESS
        return ValidationResult(TC.txSUCCESS)

    # -- fee + seqnum processing -------------------------------------------

    def process_fee_seq_num(self, ltx, base_fee: Optional[int]):
        """Charge the fee to the FEE SOURCE (ref processFeeSeqNum; the
        INNER source's seqnum is consumed during the inner tx's apply,
        like any protocol >= 10 transaction)."""
        header = ltx.header()
        fee = self.get_full_fee() if base_fee is None else min(
            self.get_full_fee(), base_fee * self.num_operations())
        with LedgerTxn(ltx) as inner:
            entry = inner.load_account(self.fee_source_id())
            if entry is None:
                raise RuntimeError("fee-bump fee source vanished")
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

    # -- apply -------------------------------------------------------------

    def apply(self, ltx, verify: Optional[Callable] = None,
              invariant_check: Optional[Callable] = None
              ) -> Tuple[bool, object, object]:
        """Apply the inner tx; wrap its result (ref apply :116 —
        chargeFee=false: the outer fee source already paid)."""
        ok, inner_result, meta = self.inner_tx.apply(
            ltx, verify=verify, invariant_check=invariant_check,
            charge_fee=False)
        self.result_code = (TC.txFEE_BUMP_INNER_SUCCESS if ok
                            else TC.txFEE_BUMP_INNER_FAILED)
        outer = self._wrap_result(inner_result)
        return ok, outer, meta

    def _wrap_result(self, inner_result) -> object:
        inner = T.InnerTransactionResult.make(
            feeCharged=inner_result.feeCharged,
            result=T.InnerTransactionResult.fields[1][1].make(
                inner_result.result.type,
                inner_result.result.value),
            ext=T.InnerTransactionResult.fields[2][1].make(0))
        pair = T.InnerTransactionResultPair.make(
            transactionHash=self.inner_hash(), result=inner)
        code = (TC.txFEE_BUMP_INNER_SUCCESS
                if inner_result.result.type == TC.txSUCCESS
                else TC.txFEE_BUMP_INNER_FAILED)
        self.result_code = code
        return T.TransactionResult.make(
            feeCharged=self.fee_charged,
            result=T.TransactionResult.fields[1][1].make(code, pair),
            ext=T.TransactionResult.fields[2][1].make(0))

    def _make_result(self, code: int, op_results) -> object:
        return T.TransactionResult.make(
            feeCharged=self.fee_charged,
            result=T.TransactionResult.fields[1][1].make(code),
            ext=T.TransactionResult.fields[2][1].make(0))

    def result_pair(self, result) -> object:
        return T.TransactionResultPair.make(
            transactionHash=self.full_hash(), result=result)
