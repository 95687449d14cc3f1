"""CreateClaimableBalance / ClaimClaimableBalance / ClawbackClaimableBalance
op frames (ref src/transactions/{CreateClaimableBalanceOpFrame,
ClaimClaimableBalanceOpFrame,ClawbackClaimableBalanceOpFrame}.cpp)."""
from __future__ import annotations

from ...crypto import sha256
from ...ledger.ledger_txn import entry_to_key
from ...xdr import types as T
from .. import sponsorship as SP
from .. import utils as U
from .base import OperationFrame, op_error, op_inner, put_account, \
    put_trustline

OT = T.OperationType
PT = T.ClaimPredicateType
SR = SP.SponsorshipResult
INT64_MAX = U.INT64_MAX


# -- predicates --------------------------------------------------------------

def validate_predicate_structure(pred, depth: int = 1) -> bool:
    """ref validatePredicate (CreateClaimableBalanceOpFrame.cpp): depth <= 4,
    AND/OR arity exactly 2, NOT present, nonnegative times."""
    if depth > 4:
        return False
    t = pred.type
    if t == PT.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t in (PT.CLAIM_PREDICATE_AND, PT.CLAIM_PREDICATE_OR):
        subs = pred.value
        if len(subs) != 2:
            return False
        return all(validate_predicate_structure(s, depth + 1) for s in subs)
    if t == PT.CLAIM_PREDICATE_NOT:
        if pred.value is None:
            return False
        return validate_predicate_structure(pred.value, depth + 1)
    if t == PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return pred.value >= 0
    if t == PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        return pred.value >= 0
    return False


def predicates_to_absolute(pred, close_time: int):
    """Relative -> absolute conversion at create time (ref
    updatePredicatesForApply), saturating at INT64_MAX."""
    t = pred.type
    if t in (PT.CLAIM_PREDICATE_AND, PT.CLAIM_PREDICATE_OR):
        return T.ClaimPredicate.make(
            t, [predicates_to_absolute(s, close_time) for s in pred.value])
    if t == PT.CLAIM_PREDICATE_NOT:
        return T.ClaimPredicate.make(
            t, predicates_to_absolute(pred.value, close_time))
    if t == PT.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        abs_t = min(close_time + pred.value, INT64_MAX)
        return T.ClaimPredicate.make(
            PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME, abs_t)
    return pred


def evaluate_predicate(pred, close_time: int) -> bool:
    """Claim-time evaluation (ref ClaimClaimableBalanceOpFrame.cpp
    validatePredicate(pred, closeTime))."""
    t = pred.type
    if t == PT.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t == PT.CLAIM_PREDICATE_AND:
        return all(evaluate_predicate(s, close_time) for s in pred.value)
    if t == PT.CLAIM_PREDICATE_OR:
        return any(evaluate_predicate(s, close_time) for s in pred.value)
    if t == PT.CLAIM_PREDICATE_NOT:
        return not evaluate_predicate(pred.value, close_time)
    if t == PT.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return pred.value > close_time
    raise ValueError("invalid claim predicate at evaluation")


def load_claimable_balance(ltx, balance_id):
    k = T.LedgerKey.make(
        T.LedgerEntryType.CLAIMABLE_BALANCE,
        T.LedgerKey.arms[T.LedgerEntryType.CLAIMABLE_BALANCE][1].make(
            balanceID=balance_id))
    return ltx.load(k)


def cb_flags(cb) -> int:
    if cb.ext.type == 1:
        return cb.ext.value.flags
    return 0


class CreateClaimableBalanceOpFrame(OperationFrame):
    TYPE = OT.CREATE_CLAIMABLE_BALANCE
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE,
                        T.CreateClaimableBalanceResult.make(code))

    def do_check_valid(self, header):
        C = T.CreateClaimableBalanceResultCode
        b = self.body
        if (not U.is_asset_valid(b.asset) or b.amount <= 0
                or not b.claimants):
            return self._res(C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        dests = set()
        for cl in b.claimants:
            d = cl.value.destination.value
            if d in dests:
                return self._res(C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
            dests.add(d)
        for cl in b.claimants:
            if not validate_predicate_structure(cl.value.predicate):
                return self._res(C.CREATE_CLAIMABLE_BALANCE_MALFORMED)
        return None

    def balance_id(self) -> bytes:
        """sha256(HashIDPreimage OP_ID {txSource, seqNum, opIndex})
        (ref CreateClaimableBalanceOpFrame::getBalanceID :301)."""
        op_index = self.tx.op_frames.index(self)
        pre = T.HashIDPreimage.make(
            T.EnvelopeType.ENVELOPE_TYPE_OP_ID,
            T.HashIDPreimage.arms[T.EnvelopeType.ENVELOPE_TYPE_OP_ID][1]
            .make(sourceAccount=T.account_id(self.tx.source_account_id()),
                  seqNum=self.tx.seq_num(), opNum=op_index))
        return sha256(T.HashIDPreimage.encode(pre))

    def do_apply(self, ltx):
        C = T.CreateClaimableBalanceResultCode
        header = ltx.header()
        b = self.body
        src_id = self.source_account_id()
        src_entry = self.load_source_account(ltx)
        src = src_entry.data.value
        clawback = False

        if U.is_native(b.asset):
            if U.get_available_balance(header, src) < b.amount:
                return self._res(C.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
            src = U.add_balance(src, -b.amount)
            put_account(ltx, src_entry, src)
        elif src_id == U.asset_issuer(b.asset):
            # issuer minting into a claimable balance; no trustline
            clawback = bool(src.flags & T.AUTH_CLAWBACK_ENABLED_FLAG)
        else:
            tl_entry = ltx.load_trustline(src_id, b.asset)
            if tl_entry is None:
                return self._res(C.CREATE_CLAIMABLE_BALANCE_NO_TRUST)
            tl = tl_entry.data.value
            if not U.is_authorized(tl):
                return self._res(C.CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
            if U.trustline_available_balance(tl) < b.amount:
                return self._res(C.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
            put_trustline(ltx, tl_entry,
                          tl._replace(balance=tl.balance - b.amount))
            clawback = U.is_clawback_enabled_tl(tl)

        bid = T.ClaimableBalanceID.make(
            T.ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
            self.balance_id())
        close_time = header.scpValue.closeTime
        claimants = [
            T.Claimant.make(cl.type, cl.value._replace(
                predicate=predicates_to_absolute(cl.value.predicate,
                                                 close_time)))
            for cl in b.claimants]
        if clawback:
            ext = T.ClaimableBalanceEntry.fields[4][1].make(
                1, T.ClaimableBalanceEntryExtensionV1.make(
                    ext=T.ClaimableBalanceEntryExtensionV1.fields[0][1]
                    .make(0),
                    flags=T.CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG))
        else:
            ext = T.ClaimableBalanceEntry.fields[4][1].make(0)
        cb = T.ClaimableBalanceEntry.make(
            balanceID=bid, claimants=claimants, asset=b.asset,
            amount=b.amount, ext=ext)
        entry = U.wrap_entry(T.LedgerEntryType.CLAIMABLE_BALANCE, cb)

        res, entry = SP.create_entry_with_possible_sponsorship(
            ltx, entry, src_id)
        err = SP.map_sponsorship_result(
            res, self._res(C.CREATE_CLAIMABLE_BALANCE_LOW_RESERVE))
        if err is not None:
            return err
        ltx.put(entry)
        return op_inner(self.TYPE, T.CreateClaimableBalanceResult.make(
            T.CreateClaimableBalanceResultCode
            .CREATE_CLAIMABLE_BALANCE_SUCCESS, bid))


class ClaimClaimableBalanceOpFrame(OperationFrame):
    TYPE = OT.CLAIM_CLAIMABLE_BALANCE
    THRESHOLD = U.ThresholdLevel.LOW

    def _res(self, code):
        return op_inner(self.TYPE, T.ClaimClaimableBalanceResult.make(code))

    def do_apply(self, ltx):
        C = T.ClaimClaimableBalanceResultCode
        header = ltx.header()
        src_id = self.source_account_id()
        entry = load_claimable_balance(ltx, self.body.balanceID)
        if entry is None:
            return self._res(C.CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
        cb = entry.data.value

        claimant = next(
            (cl for cl in cb.claimants
             if cl.value.destination.value == src_id), None)
        if claimant is None or not evaluate_predicate(
                claimant.value.predicate, header.scpValue.closeTime):
            return self._res(C.CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM)

        if U.is_native(cb.asset):
            src_entry = self.load_source_account(ltx)
            src = src_entry.data.value
            if U.get_max_receive(header, src) < cb.amount:
                return self._res(C.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            put_account(ltx, src_entry, U.add_balance(src, cb.amount))
        elif src_id == U.asset_issuer(cb.asset):
            pass  # issuer claiming own asset burns it
        else:
            tl_entry = ltx.load_trustline(src_id, cb.asset)
            if tl_entry is None:
                return self._res(C.CLAIM_CLAIMABLE_BALANCE_NO_TRUST)
            tl = tl_entry.data.value
            if not U.is_authorized(tl):
                return self._res(C.CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
            if U.trustline_max_receive(tl) < cb.amount:
                return self._res(C.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
            put_trustline(ltx, tl_entry,
                          tl._replace(balance=tl.balance + cb.amount))

        SP.remove_entry_with_possible_sponsorship(ltx, entry, None)
        ltx.erase(entry_to_key(entry))
        return self._res(C.CLAIM_CLAIMABLE_BALANCE_SUCCESS)


class ClawbackClaimableBalanceOpFrame(OperationFrame):
    TYPE = OT.CLAWBACK_CLAIMABLE_BALANCE
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE,
                        T.ClawbackClaimableBalanceResult.make(code))

    def do_apply(self, ltx):
        C = T.ClawbackClaimableBalanceResultCode
        src_id = self.source_account_id()
        entry = load_claimable_balance(ltx, self.body.balanceID)
        if entry is None:
            return self._res(C.CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
        cb = entry.data.value
        if U.is_native(cb.asset) or src_id != U.asset_issuer(cb.asset):
            return self._res(C.CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER)
        if not cb_flags(cb) & T.CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG:
            return self._res(
                C.CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED)
        # the reference loads the source account for the sponsorship
        # release (doApply :37-40); the load is RECORDED, so the meta
        # carries the (unchanged) source entry — mirror with a self-put
        src_entry = self.load_source_account(ltx)
        ltx.put(src_entry)
        SP.remove_entry_with_possible_sponsorship(ltx, entry, None)
        ltx.erase(entry_to_key(entry))
        return self._res(C.CLAWBACK_CLAIMABLE_BALANCE_SUCCESS)
