"""OperationFrame base: per-op validity + apply
(ref src/transactions/OperationFrame.cpp).

Subclasses set ``THRESHOLD`` and implement ``do_check_valid`` (state-free)
and ``do_apply`` (mutations through a LedgerTxn).  Results are XDR
``OperationResult`` values.
"""
from __future__ import annotations

from typing import Optional

from ...xdr import types as T
from .. import utils as U


def op_inner(op_type: int, result_value) -> object:
    return T.OperationResult.make(
        T.OperationResultCode.opINNER,
        T.OperationResultTr.make(op_type, result_value))


def put_account(ltx, entry, acc) -> None:
    ltx.put(entry._replace(
        data=T.LedgerEntryData.make(T.LedgerEntryType.ACCOUNT, acc)))


def put_trustline(ltx, entry, tl) -> None:
    ltx.put(entry._replace(
        data=T.LedgerEntryData.make(T.LedgerEntryType.TRUSTLINE, tl)))


def op_error(code: int) -> object:
    return T.OperationResult.make(code)


class OperationFrame:
    TYPE: int = -1
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def __init__(self, op, tx):
        self.op = op            # XDR Operation
        self.body = op.body.value
        self.tx = tx            # TransactionFrame
        self.result: Optional[object] = None

    # -- source account ----------------------------------------------------

    def source_account_id(self) -> bytes:
        if self.op.sourceAccount is not None:
            return U.muxed_to_account_id(self.op.sourceAccount)
        return self.tx.source_account_id()

    def load_source_account(self, ltx):
        return ltx.load_account(self.source_account_id())

    def threshold_level(self) -> int:
        return self.THRESHOLD

    # -- subclass surface --------------------------------------------------

    def do_check_valid(self, header) -> Optional[object]:
        """Return an error OperationResult or None when valid."""
        return None

    def do_apply(self, ltx) -> object:
        raise NotImplementedError

    # -- engine ------------------------------------------------------------

    def check_signatures(self, ltx, checker) -> bool:
        """Per-op source account auth at the op's threshold level
        (ref OperationFrame::checkSignature)."""
        from ..signature_checker import account_signers

        entry = self.load_source_account(ltx)
        if entry is None:
            # op source must exist at apply; for checkValid only the
            # tx-level source is required to exist (ref: checkSignature
            # with no account uses just the op source key at weight 0)
            skey = T.SignerKey.make(
                T.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                self.source_account_id())
            return checker.check_signature([(skey, 1)], 1)
        acc = entry.data.value
        needed = U.threshold(acc, self.threshold_level())
        return checker.check_signature(account_signers(acc), max(needed, 1))

    def is_supported(self, header) -> bool:
        """ref OperationFrame::isOpSupported — checked FIRST, before
        signatures (OperationFrame.cpp:240-245); INFLATION is the one
        protocol-19 op that is no longer supported."""
        return True

    def apply(self, ltx, checker) -> bool:
        """Auth + account existence + do_apply; returns success, with
        ``self.result`` holding the OperationResult."""
        if not self.is_supported(ltx.header()):
            self.result = op_error(T.OperationResultCode.opNOT_SUPPORTED)
            return False
        if not self.check_signatures(ltx, checker):
            self.result = op_error(T.OperationResultCode.opBAD_AUTH)
            return False
        if self.load_source_account(ltx) is None:
            self.result = op_error(T.OperationResultCode.opNO_ACCOUNT)
            return False
        err = self.do_check_valid(ltx.header())
        if err is not None:
            self.result = err
            return False
        self.result = self.do_apply(ltx)
        return self._is_success(self.result)

    def check_valid(self, header) -> bool:
        if not self.is_supported(header):
            self.result = op_error(T.OperationResultCode.opNOT_SUPPORTED)
            return False
        err = self.do_check_valid(header)
        if err is not None:
            self.result = err
            return False
        return True

    @staticmethod
    def _is_success(result) -> bool:
        if result.type != T.OperationResultCode.opINNER:
            return False
        per_op = result.value.value  # e.g. a PaymentResult union value
        return per_op.type == 0
