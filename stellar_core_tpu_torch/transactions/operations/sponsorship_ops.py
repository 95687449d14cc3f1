"""BeginSponsoringFutureReserves / EndSponsoringFutureReserves /
RevokeSponsorship op frames
(ref src/transactions/{BeginSponsoringFutureReservesOpFrame,
EndSponsoringFutureReservesOpFrame,RevokeSponsorshipOpFrame}.cpp)."""
from __future__ import annotations

from ...ledger.ledger_txn import sponsorship_counter_key, sponsorship_key
from ...xdr import types as T
from .. import sponsorship as SP
from .. import utils as U
from .base import OperationFrame, op_error, op_inner

OT = T.OperationType
SR = SP.SponsorshipResult


class BeginSponsoringFutureReservesOpFrame(OperationFrame):
    TYPE = OT.BEGIN_SPONSORING_FUTURE_RESERVES
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(
            self.TYPE, T.BeginSponsoringFutureReservesResult.make(code))

    def do_check_valid(self, header):
        C = T.BeginSponsoringFutureReservesResultCode
        if self.body.sponsoredID.value == self.source_account_id():
            return self._res(C.BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.BeginSponsoringFutureReservesResultCode
        src = self.source_account_id()
        sponsored = self.body.sponsoredID.value
        if SP.load_sponsorship(ltx, sponsored) is not None:
            return self._res(
                C.BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED)
        # recursion guards (ref BeginSponsoring...OpFrame.cpp:64-81):
        # the sponsor must not itself be sponsored, and the sponsored
        # account must not be sponsoring anyone
        if SP.load_sponsorship(ltx, src) is not None:
            return self._res(C.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)
        if SP.load_sponsorship_counter(ltx, sponsored):
            return self._res(C.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)
        ltx.put_virtual(sponsorship_key(sponsored), src)
        ltx.put_virtual(sponsorship_counter_key(src),
                        SP.load_sponsorship_counter(ltx, src) + 1)
        return self._res(C.BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS)


class EndSponsoringFutureReservesOpFrame(OperationFrame):
    TYPE = OT.END_SPONSORING_FUTURE_RESERVES
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(
            self.TYPE, T.EndSponsoringFutureReservesResult.make(code))

    def do_apply(self, ltx):
        C = T.EndSponsoringFutureReservesResultCode
        src = self.source_account_id()
        sponsor = SP.load_sponsorship(ltx, src)
        if sponsor is None:
            return self._res(
                C.END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED)
        ltx.erase_virtual(sponsorship_key(src))
        count = SP.load_sponsorship_counter(ltx, sponsor)
        if count <= 1:
            ltx.erase_virtual(sponsorship_counter_key(sponsor))
        else:
            ltx.put_virtual(sponsorship_counter_key(sponsor), count - 1)
        return self._res(C.END_SPONSORING_FUTURE_RESERVES_SUCCESS)


def _entry_owner_id(entry):
    """ref RevokeSponsorshipOpFrame getAccountID: the account whose reserve
    the entry consumes (for claimable balances, the recorded sponsor)."""
    LE = T.LedgerEntryType
    d = entry.data
    if d.type == LE.ACCOUNT:
        return d.value.accountID.value
    if d.type == LE.TRUSTLINE:
        return d.value.accountID.value
    if d.type == LE.OFFER:
        return d.value.sellerID.value
    if d.type == LE.DATA:
        return d.value.accountID.value
    if d.type == LE.CLAIMABLE_BALANCE:
        return SP.entry_sponsor(entry)
    raise SP.SponsorshipError(f"bad entry type {d.type}")


class RevokeSponsorshipOpFrame(OperationFrame):
    TYPE = OT.REVOKE_SPONSORSHIP
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.RevokeSponsorshipResult.make(code))

    def do_check_valid(self, header):
        C = T.RevokeSponsorshipResultCode
        if self.body.type == T.RevokeSponsorshipType.\
                REVOKE_SPONSORSHIP_LEDGER_ENTRY:
            key = self.body.value
            LE = T.LedgerEntryType
            if key.type == LE.ACCOUNT:
                pass
            elif key.type == LE.TRUSTLINE:
                asset = key.value.asset
                if asset.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
                    pass
                elif not U.is_asset_valid(
                        T.Asset.make(asset.type, asset.value)):
                    return self._res(C.REVOKE_SPONSORSHIP_MALFORMED)
            elif key.type == LE.OFFER:
                if key.value.offerID <= 0:
                    return self._res(C.REVOKE_SPONSORSHIP_MALFORMED)
            elif key.type == LE.DATA:
                name = key.value.dataName
                if not name or len(name) > 64:
                    return self._res(C.REVOKE_SPONSORSHIP_MALFORMED)
            elif key.type == LE.CLAIMABLE_BALANCE:
                pass
            else:
                return self._res(C.REVOKE_SPONSORSHIP_MALFORMED)
        return None

    def _map_result(self, res: int):
        C = T.RevokeSponsorshipResultCode
        return SP.map_sponsorship_result(
            res, self._res(C.REVOKE_SPONSORSHIP_LOW_RESERVE))

    def do_apply(self, ltx):
        if self.body.type == T.RevokeSponsorshipType.\
                REVOKE_SPONSORSHIP_LEDGER_ENTRY:
            return self._apply_ledger_entry(ltx)
        return self._apply_signer(ltx)

    def _apply_ledger_entry(self, ltx):
        C = T.RevokeSponsorshipResultCode
        src = self.source_account_id()
        entry = ltx.load(self.body.value)
        if entry is None:
            return self._res(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        owner_id = _entry_owner_id(entry)

        was_sponsored = SP.entry_sponsor(entry) is not None
        if was_sponsored:
            if SP.entry_sponsor(entry) != src:
                return self._res(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        elif owner_id != src:
            return self._res(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)

        # SponsoringFutureReserves(src)=None -> entry becomes owner-paid;
        # =owner -> owner-paid; =C!=owner -> sponsored by C  (ref :120-127)
        new_sponsor = SP.load_sponsorship(ltx, src)
        will_be_sponsored = (new_sponsor is not None
                             and new_sponsor != owner_id)

        is_cb = entry.data.type == T.LedgerEntryType.CLAIMABLE_BALANCE
        if not will_be_sponsored and is_cb:
            return self._res(C.REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE)

        if was_sponsored and will_be_sponsored:
            res, entry = SP.transfer_entry_sponsorship(ltx, entry,
                                                       new_sponsor)
        elif was_sponsored:
            res, entry = SP.remove_entry_sponsorship(ltx, entry, owner_id)
        elif will_be_sponsored:
            res, entry = SP.establish_entry_sponsorship(
                ltx, entry, new_sponsor, owner_id)
        else:
            return self._res(C.REVOKE_SPONSORSHIP_SUCCESS)
        if res != SR.SUCCESS:
            return self._map_result(res)
        ltx.put(entry)
        return self._res(C.REVOKE_SPONSORSHIP_SUCCESS)

    def _apply_signer(self, ltx):
        C = T.RevokeSponsorshipResultCode
        src = self.source_account_id()
        account_id = self.body.value.accountID.value
        acc_entry = ltx.load_account(account_id)
        if acc_entry is None:
            return self._res(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
        acc = acc_entry.data.value
        skey_b = T.SignerKey.encode(self.body.value.signerKey)
        idx = next((i for i, s in enumerate(acc.signers)
                    if T.SignerKey.encode(s.key) == skey_b), None)
        if idx is None:
            return self._res(C.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)

        sids = SP.signer_sponsoring_ids(acc)
        cur_sponsor = sids[idx].value if sids[idx] is not None else None
        was_sponsored = cur_sponsor is not None
        if was_sponsored:
            if cur_sponsor != src:
                return self._res(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)
        elif account_id != src:
            return self._res(C.REVOKE_SPONSORSHIP_NOT_SPONSOR)

        new_sponsor = SP.load_sponsorship(ltx, src)
        will_be_sponsored = (new_sponsor is not None
                             and new_sponsor != account_id)

        header = ltx.header()
        if was_sponsored and will_be_sponsored:
            old_entry = ltx.load_account(cur_sponsor)
            new_entry = ltx.load_account(new_sponsor)
            res = SP._can_remove(header, old_entry.data.value, None, 1)
            if res == SR.SUCCESS:
                res = SP._can_establish(
                    header, new_entry.data.value, acc, 1)
            if res != SR.SUCCESS:
                return self._map_result(res)
            SP._put_account(ltx, old_entry,
                            SP.add_num_sponsoring(old_entry.data.value, -1))
            new_entry = ltx.load_account(new_sponsor)
            SP._put_account(ltx, new_entry,
                            SP.add_num_sponsoring(new_entry.data.value, 1))
            sids[idx] = T.account_id(new_sponsor)
        elif was_sponsored:
            old_entry = ltx.load_account(cur_sponsor)
            res = SP._can_remove(header, old_entry.data.value, acc, 1)
            if res != SR.SUCCESS:
                return self._map_result(res)
            SP._put_account(ltx, old_entry,
                            SP.add_num_sponsoring(old_entry.data.value, -1))
            acc = SP.add_num_sponsored(acc, -1)
            sids[idx] = None
        elif will_be_sponsored:
            new_entry = ltx.load_account(new_sponsor)
            res = SP._can_establish(header, new_entry.data.value, acc, 1)
            if res != SR.SUCCESS:
                return self._map_result(res)
            SP._put_account(ltx, new_entry,
                            SP.add_num_sponsoring(new_entry.data.value, 1))
            acc = SP.add_num_sponsored(acc, 1)
            sids[idx] = T.account_id(new_sponsor)
        else:
            return self._res(C.REVOKE_SPONSORSHIP_SUCCESS)

        acc = SP.set_signer_sponsoring_ids(acc, sids)
        SP._put_account(ltx, acc_entry, acc)
        return self._res(C.REVOKE_SPONSORSHIP_SUCCESS)
