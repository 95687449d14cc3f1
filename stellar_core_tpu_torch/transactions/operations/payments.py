"""CreateAccount + Payment + AccountMerge op frames
(ref src/transactions/{CreateAccountOpFrame,PaymentOpFrame,
MergeOpFrame}.cpp)."""
from __future__ import annotations

from ...xdr import types as T
from .. import utils as U
from .base import (
    OperationFrame, op_error, op_inner, put_account, put_trustline,
)

OT = T.OperationType


class CreateAccountOpFrame(OperationFrame):
    TYPE = OT.CREATE_ACCOUNT
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.CreateAccountResult.make(code))

    def do_check_valid(self, header):
        C = T.CreateAccountResultCode
        if self.body.startingBalance < 0:
            return self._res(C.CREATE_ACCOUNT_MALFORMED)
        if self.body.destination.value == self.source_account_id():
            return self._res(C.CREATE_ACCOUNT_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.CreateAccountResultCode
        from .. import sponsorship as SP

        header = ltx.header()
        dest = self.body.destination.value
        if ltx.load_account(dest) is not None:
            return self._res(C.CREATE_ACCOUNT_ALREADY_EXIST)

        # new accounts start at seqNum = ledgerSeq << 32 (ref
        # getStartingSequenceNumber — guarantees no replay of txs signed
        # before the account existed)
        new_entry = U.make_account_entry(
            dest, self.body.startingBalance,
            seq_num=header.ledgerSeq << 32)
        # reserve: paid by the new balance itself, or by the active sponsor
        # of the DESTINATION id (ref CreateAccountOpFrame::doApply ->
        # createEntryWithPossibleSponsorship with sponsoredID = dest)
        res, new_entry = SP.create_entry_with_possible_sponsorship(
            ltx, new_entry, dest, owner_entry=new_entry)
        err = SP.map_sponsorship_result(
            res, self._res(C.CREATE_ACCOUNT_LOW_RESERVE))
        if err is not None:
            return err
        # debit AFTER the sponsorship accounting: if the source is itself
        # the sponsor, numSponsoring just raised its reserve floor (ref
        # addBalance enforcing newBalance >= minBalance on debit)
        src_entry = self.load_source_account(ltx)
        src = src_entry.data.value
        if U.get_available_balance(header, src) < self.body.startingBalance:
            return self._res(C.CREATE_ACCOUNT_UNDERFUNDED)
        put_account(ltx, src_entry,
                    U.add_balance(src, -self.body.startingBalance))
        ltx.put(new_entry)
        return self._res(C.CREATE_ACCOUNT_SUCCESS)


class PaymentOpFrame(OperationFrame):
    TYPE = OT.PAYMENT
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.PaymentResult.make(code))

    def do_check_valid(self, header):
        C = T.PaymentResultCode
        if self.body.amount <= 0:
            return self._res(C.PAYMENT_MALFORMED)
        if not U.is_asset_valid(self.body.asset):
            return self._res(C.PAYMENT_MALFORMED)
        return None

    def do_apply(self, ltx):
        """Mirrors the reference's PathPaymentStrictReceive core with an
        empty path: credit the DESTINATION first, then debit the SOURCE
        re-reading through the ltx (a self-payment therefore nets to zero
        through the same entry, and the meta records the touched entries
        exactly like the reference's).  Ref PathPaymentStrictReceive
        OpFrame::doApply + PathPaymentOpFrameBase::updateDestBalance
        :213 / updateSourceBalance :142; check ORDER (dest LINE_FULL
        before src UNDERFUNDED) is protocol-visible at v11+."""
        C = T.PaymentResultCode
        header = ltx.header()
        asset = self.body.asset
        amount = self.body.amount
        src_id = self.source_account_id()
        dest_id = U.muxed_to_account_id(self.body.destination)
        issuer = None if U.is_native(asset) else U.asset_issuer(asset)

        # dest-existence check is bypassed when sending credits straight
        # back to their issuer (ref shouldBypassIssuerCheck)
        bypass_issuer_check = issuer is not None and dest_id == issuer
        if not bypass_issuer_check and ltx.load_account(dest_id) is None:
            return self._res(C.PAYMENT_NO_DESTINATION)

        # -- 1) credit the destination (ref updateDestBalance) -----------
        if U.is_native(asset):
            dest_entry = ltx.load_account(dest_id)
            dest = dest_entry.data.value
            if U.get_max_receive(header, dest) < amount:
                return self._res(C.PAYMENT_LINE_FULL)
            put_account(ltx, dest_entry, U.add_balance(dest, amount))
        elif dest_id != issuer:  # the issuer's line is infinite
            dtl_entry = ltx.load_trustline(dest_id, asset)
            if dtl_entry is None:
                return self._res(C.PAYMENT_NO_TRUST)
            dtl = dtl_entry.data.value
            if not U.is_authorized(dtl):
                return self._res(C.PAYMENT_NOT_AUTHORIZED)
            if U.trustline_max_receive(dtl) < amount:
                return self._res(C.PAYMENT_LINE_FULL)
            put_trustline(ltx, dtl_entry,
                          dtl._replace(balance=dtl.balance + amount))

        # -- 2) debit the source (ref updateSourceBalance) ---------------
        if U.is_native(asset):
            src_entry = ltx.load_account(src_id)  # re-read: may be dest
            src = src_entry.data.value
            if amount > U.get_available_balance(header, src):
                return self._res(C.PAYMENT_UNDERFUNDED)
            put_account(ltx, src_entry, U.add_balance(src, -amount))
        elif src_id != issuer:
            tl_entry = ltx.load_trustline(src_id, asset)
            if tl_entry is None:
                return self._res(C.PAYMENT_SRC_NO_TRUST)
            tl = tl_entry.data.value
            if not U.is_authorized(tl):
                return self._res(C.PAYMENT_SRC_NOT_AUTHORIZED)
            if U.trustline_available_balance(tl) < amount:
                return self._res(C.PAYMENT_UNDERFUNDED)
            put_trustline(ltx, tl_entry,
                          tl._replace(balance=tl.balance - amount))
        return self._res(C.PAYMENT_SUCCESS)


class AccountMergeOpFrame(OperationFrame):
    TYPE = OT.ACCOUNT_MERGE
    THRESHOLD = U.ThresholdLevel.HIGH

    def _res_code(self, code):
        return op_inner(self.TYPE, T.AccountMergeResult.make(code))

    def do_check_valid(self, header):
        C = T.AccountMergeResultCode
        dest = U.muxed_to_account_id(self.body)
        if dest == self.source_account_id():
            return self._res_code(C.ACCOUNT_MERGE_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.AccountMergeResultCode
        header = ltx.header()
        src_id = self.source_account_id()
        dest_id = U.muxed_to_account_id(self.body)

        dest_entry = ltx.load_account(dest_id)
        if dest_entry is None:
            return self._res_code(C.ACCOUNT_MERGE_NO_ACCOUNT)
        src_entry = self.load_source_account(ltx)
        src = src_entry.data.value
        if src.flags & T.AUTH_IMMUTABLE_FLAG:
            return self._res_code(C.ACCOUNT_MERGE_IMMUTABLE_SET)
        # signers are the one subentry type allowed at merge time (ref
        # MergeOpFrame: numSubEntries != signers.size() -> HAS_SUB_ENTRIES)
        if src.numSubEntries != len(src.signers):
            return self._res_code(C.ACCOUNT_MERGE_HAS_SUB_ENTRIES)
        if U.num_sponsoring(src) != 0:
            return self._res_code(C.ACCOUNT_MERGE_IS_SPONSOR)
        # seqnum must not be re-usable in this ledger (protocol >= 10):
        # reject only seqNum >= startingSequenceNumber(ledgerSeq)
        if src.seqNum >= (header.ledgerSeq << 32):
            return self._res_code(C.ACCOUNT_MERGE_SEQNUM_TOO_FAR)
        dest = dest_entry.data.value
        if U.get_max_receive(header, dest) < src.balance:
            return self._res_code(C.ACCOUNT_MERGE_DEST_FULL)

        balance = src.balance
        dest = U.add_balance(dest, balance)
        put_account(ltx, dest_entry, dest)
        from ...ledger.ledger_txn import entry_to_key
        from .. import sponsorship as SP

        # release every sponsored signer's reserve (the account dies, so
        # only the sponsors' numSponsoring needs correcting — ref
        # MergeOpFrame removing signer sponsorships before the erase)
        for sid in SP.signer_sponsoring_ids(src):
            if sid is not None:
                SP.release_signer_sponsorship(ltx, sid.value)
        # release the account-entry sponsorship, if any (mult 2)
        src_entry = ltx.load_account(src_id)
        SP.remove_entry_with_possible_sponsorship(ltx, src_entry, None)
        ltx.erase(entry_to_key(src_entry))
        return op_inner(self.TYPE, T.AccountMergeResult.make(
            C.ACCOUNT_MERGE_SUCCESS, balance))
