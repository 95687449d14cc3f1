"""ManageSellOffer / ManageBuyOffer / CreatePassiveSellOffer +
PathPaymentStrictReceive / PathPaymentStrictSend op frames
(ref src/transactions/{ManageOfferOpFrameBase,ManageBuyOfferOpFrame,
CreatePassiveSellOfferOpFrame,PathPaymentStrictReceiveOpFrame,
PathPaymentStrictSendOpFrame}.cpp)."""
from __future__ import annotations

from typing import List, Optional

from ...xdr import types as T
from .. import sponsorship as SP
from .. import utils as U
from ..offer_exchange import (
    ConvertResult, ExchangeError, INT64_MAX, RoundingType,
    adjust_offer_amount, apply_offer_liabilities, big_divide,
    can_buy_at_most, can_sell_at_most, convert_with_offers,
    convert_with_offers_and_pools, _credit,
)
from .base import OperationFrame, op_inner, put_account

OT = T.OperationType


def _price_valid(p) -> bool:
    return p.n > 0 and p.d > 0


def _zero_offer_entry(src_id: bytes, selling, buying, price, sponsor=None):
    """0-amount OfferEntry used for up-front reserve bookkeeping: the
    create-side dummy and remove-side ghost must stay field-identical so
    sponsorship accounting balances (ref buildOffer(0, 0, ext))."""
    return U.wrap_entry(
        T.LedgerEntryType.OFFER,
        T.OfferEntry.make(
            sellerID=T.account_id(src_id), offerID=0,
            selling=selling, buying=buying, amount=0,
            price=price, flags=0,
            ext=T.OfferEntry.fields[7][1].make(0)),
        sponsor=sponsor)


def _crosses(book_price, own_price, own_passive: bool,
             book_passive: bool) -> bool:
    """Book offer sells wheat at book_price (sheep/wheat); our offer sells
    sheep at own_price (wheat/sheep).  Crossing iff book_price <= 1/own:
    book.n * own.n <= book.d * own.d; equality doesn't cross when either
    side is passive (ref OfferExchange price-crossing + PASSIVE_FLAG)."""
    lhs = book_price.n * own_price.n
    rhs = book_price.d * own_price.d
    if lhs < rhs:
        return True
    if lhs == rhs:
        return not (own_passive or book_passive)
    return False


class ManageOfferOpFrameBase(OperationFrame):
    """Shared engine for sell/buy/passive offers
    (ref ManageOfferOpFrameBase.cpp)."""

    PASSIVE = False
    IS_BUY = False

    # subclass accessors -----------------------------------------------------

    def _params(self):
        """-> (selling, buying, amount-in-selling, sell-price, offerID)."""
        raise NotImplementedError

    def _result_type(self):
        raise NotImplementedError

    def _res(self, code, success=None):
        rt = self._result_type()
        return op_inner(self.TYPE, rt.make(code, success))

    def _codes(self):
        raise NotImplementedError

    # validity ---------------------------------------------------------------

    def do_check_valid(self, header):
        C = self._codes()
        selling, buying, amount, price, offer_id = self._params()
        if not U.is_asset_valid(selling) or not U.is_asset_valid(buying):
            return self._res(C["MALFORMED"])
        if U.assets_equal(selling, buying):
            return self._res(C["MALFORMED"])
        if not _price_valid(price) or amount < 0 or offer_id < 0:
            return self._res(C["MALFORMED"])
        if amount == 0 and offer_id == 0:
            return self._res(C["MALFORMED"])
        return None

    # apply ------------------------------------------------------------------

    def do_apply(self, ltx):
        C = self._codes()
        header = ltx.header()
        src_id = self.source_account_id()
        selling, buying, amount, price, offer_id = self._params()

        if amount == 0:
            # delete: no trustline prerequisites (ref checkOfferValid:38
            # "don't bother loading trust lines as we're deleting")
            existing_entry = ltx.load_offer(src_id, offer_id)
            if existing_entry is None:
                return self._res(C["NOT_FOUND"])
            from ..offer_exchange import _delete_offer

            _delete_offer(ltx, existing_entry)
            return self._res(0, T.ManageOfferSuccessResult.make(
                offersClaimed=[],
                offer=T.ManageOfferSuccessResult.fields[1][1].make(
                    T.ManageOfferEffect.MANAGE_OFFER_DELETED)))

        # trustline prerequisites (ref checkOfferValid)
        if not U.is_native(selling) and \
                U.asset_issuer(selling) != src_id:
            tl = ltx.load_trustline(src_id, selling)
            if U.asset_issuer(selling) is not None and \
                    ltx.load_account(U.asset_issuer(selling)) is None:
                return self._res(C["SELL_NO_ISSUER"])
            if tl is None:
                return self._res(C["SELL_NO_TRUST"])
            if not U.is_authorized(tl.data.value):
                return self._res(C["SELL_NOT_AUTHORIZED"])
        if not U.is_native(buying) and U.asset_issuer(buying) != src_id:
            tl = ltx.load_trustline(src_id, buying)
            if U.asset_issuer(buying) is not None and \
                    ltx.load_account(U.asset_issuer(buying)) is None:
                return self._res(C["BUY_NO_ISSUER"])
            if tl is None:
                return self._res(C["BUY_NO_TRUST"])
            if not U.is_authorized(tl.data.value):
                return self._res(C["BUY_NOT_AUTHORIZED"])

        existing_entry = None
        if offer_id != 0:
            existing_entry = ltx.load_offer(src_id, offer_id)
            if existing_entry is None:
                return self._res(C["NOT_FOUND"])

        offer_sponsor = None
        existing_flags = None
        if existing_entry is not None:
            # modify: release + erase but KEEP the subentry reservation
            # (ref doApply v14+: "sellSheepOffer is deleted but
            # sourceAccount is not updated"); the rebuilt offer keeps the
            # loaded offer's flags and sponsor
            from ...ledger.ledger_txn import entry_to_key

            offer_sponsor = SP.entry_sponsor(existing_entry)
            existing_flags = existing_entry.data.value.flags
            apply_offer_liabilities(ltx, existing_entry.data.value, -1)
            ltx.erase(entry_to_key(existing_entry))
        else:
            # new offer: reserve the subentry + check reserve BEFORE
            # crossing, so capacities and the final liability acquire see
            # the same minBalance (ref doApply v14+: "establishing the
            # numSubEntries ... changes" up front, via
            # createEntryWithPossibleSponsorship on a 0-amount offer)
            dummy = _zero_offer_entry(src_id, selling, buying, price)
            res, dummy = SP.create_entry_with_possible_sponsorship(
                ltx, dummy, src_id)
            err = SP.map_sponsorship_result(
                res, self._res(C["LOW_RESERVE"]))
            if err is not None:
                return err
            offer_sponsor = SP.entry_sponsor(dummy)

        # the FULL offer's liabilities must fit capacity up front (ref
        # computeOfferExchangeParameters:151-201: LINE_FULL when the
        # buying liabilities exceed the available limit, UNDERFUNDED when
        # the selling liabilities exceed the available balance)
        from ..offer_exchange import (
            offer_buying_liabilities, offer_selling_liabilities,
        )

        sell_capacity = can_sell_at_most(header, ltx, src_id, selling)
        buy_capacity = can_buy_at_most(header, ltx, src_id, buying)
        if buy_capacity < offer_buying_liabilities(price, amount):
            return self._res(C["LINE_FULL"])
        if sell_capacity < offer_selling_liabilities(price, amount):
            return self._res(C["UNDERFUNDED"])
        # crossing limits (ref applyOperationSpecificLimits)
        max_sheep_send = min(amount, sell_capacity)
        max_wheat_receive = buy_capacity
        if self.IS_BUY:
            max_wheat_receive = min(max_wheat_receive, self._buy_amount())

        own_passive = self.PASSIVE

        def price_filter(book_offer) -> bool:
            return _crosses(
                book_offer.price, price, own_passive,
                bool(book_offer.flags & T.PASSIVE_FLAG))

        try:
            result, sheep_sent, wheat_recv, atoms = convert_with_offers(
                ltx, header, src_id, selling, max_sheep_send,
                buying, max_wheat_receive, RoundingType.NORMAL,
                price_filter)
        except ExchangeError:
            return self._res(C["MALFORMED"])
        if result == ConvertResult.CROSSED_SELF:
            return self._res(C["CROSS_SELF"])
        if result == ConvertResult.TOO_MANY_OFFERS:
            return self._res(C["MALFORMED"])

        # settle taker's side of the trades
        if sheep_sent > 0:
            if not _credit(ltx, header, src_id, selling, -sheep_sent):
                return self._res(C["UNDERFUNDED"])
        if wheat_recv > 0:
            if not _credit(ltx, header, src_id, buying, wheat_recv):
                return self._res(C["LINE_FULL"])

        # residual resting amount re-adjusted to post-settle capacities
        # (ref ManageOfferOpFrameBase.cpp:440-456: canSellAtMost /
        # canBuyAtMost with the operation's own limits applied)
        sheep_limit = min(amount - sheep_sent,
                          can_sell_at_most(header, ltx, src_id, selling))
        wheat_limit = can_buy_at_most(header, ltx, src_id, buying)
        if self.IS_BUY:
            wheat_limit = min(wheat_limit,
                              self._buy_amount() - wheat_recv)
        amount_left = adjust_offer_amount(price, sheep_limit, wheat_limit)

        if amount_left <= 0:
            # nothing rests: give back the up-front reservation (ref
            # removeEntryWithPossibleSponsorship on the 0-amount offer)
            ghost = _zero_offer_entry(src_id, selling, buying, price,
                                      sponsor=offer_sponsor)
            SP.remove_entry_with_possible_sponsorship(ltx, ghost, src_id)
            return self._res(0, T.ManageOfferSuccessResult.make(
                offersClaimed=atoms,
                offer=T.ManageOfferSuccessResult.fields[1][1].make(
                    T.ManageOfferEffect.MANAGE_OFFER_DELETED)))

        # write the residual resting offer (subentry already reserved)
        new_id = offer_id
        if existing_entry is None:
            new_id = header.idPool + 1
            ltx.set_header(ltx.header()._replace(idPool=new_id))
        oe = T.OfferEntry.make(
            sellerID=T.account_id(src_id),
            offerID=new_id,
            selling=selling,
            buying=buying,
            amount=amount_left,
            price=price,
            flags=(existing_flags if existing_flags is not None
                   else (T.PASSIVE_FLAG if self.PASSIVE else 0)),
            ext=T.OfferEntry.fields[7][1].make(0))
        ltx.put(U.wrap_entry(T.LedgerEntryType.OFFER, oe,
                             sponsor=offer_sponsor))
        if not apply_offer_liabilities(ltx, oe, 1):
            # cannot happen: amount_left was adjusted to capacities above
            raise RuntimeError("resting offer liabilities do not fit")
        effect = (T.ManageOfferEffect.MANAGE_OFFER_CREATED
                  if existing_entry is None
                  else T.ManageOfferEffect.MANAGE_OFFER_UPDATED)
        return self._res(0, T.ManageOfferSuccessResult.make(
            offersClaimed=atoms,
            offer=T.ManageOfferSuccessResult.fields[1][1].make(effect, oe)))

    def _buy_amount(self) -> int:
        return INT64_MAX


def _sell_codes(prefix: str):
    E = T.ManageSellOfferResultCode
    return {
        "MALFORMED": E.MANAGE_SELL_OFFER_MALFORMED,
        "SELL_NO_TRUST": E.MANAGE_SELL_OFFER_SELL_NO_TRUST,
        "BUY_NO_TRUST": E.MANAGE_SELL_OFFER_BUY_NO_TRUST,
        "SELL_NOT_AUTHORIZED": E.MANAGE_SELL_OFFER_SELL_NOT_AUTHORIZED,
        "BUY_NOT_AUTHORIZED": E.MANAGE_SELL_OFFER_BUY_NOT_AUTHORIZED,
        "LINE_FULL": E.MANAGE_SELL_OFFER_LINE_FULL,
        "UNDERFUNDED": E.MANAGE_SELL_OFFER_UNDERFUNDED,
        "CROSS_SELF": E.MANAGE_SELL_OFFER_CROSS_SELF,
        "SELL_NO_ISSUER": E.MANAGE_SELL_OFFER_SELL_NO_ISSUER,
        "BUY_NO_ISSUER": E.MANAGE_SELL_OFFER_BUY_NO_ISSUER,
        "NOT_FOUND": E.MANAGE_SELL_OFFER_NOT_FOUND,
        "LOW_RESERVE": E.MANAGE_SELL_OFFER_LOW_RESERVE,
    }


class ManageSellOfferOpFrame(ManageOfferOpFrameBase):
    TYPE = OT.MANAGE_SELL_OFFER

    def _params(self):
        b = self.body
        return (b.selling, b.buying, b.amount, b.price, b.offerID)

    def _result_type(self):
        return T.ManageSellOfferResult

    def _codes(self):
        return _sell_codes("MANAGE_SELL_OFFER")


class CreatePassiveSellOfferOpFrame(ManageOfferOpFrameBase):
    TYPE = OT.CREATE_PASSIVE_SELL_OFFER
    PASSIVE = True

    def _params(self):
        b = self.body
        return (b.selling, b.buying, b.amount, b.price, 0)

    def _result_type(self):
        return T.ManageSellOfferResult

    def _codes(self):
        return _sell_codes("MANAGE_SELL_OFFER")

    def do_check_valid(self, header):
        C = self._codes()
        b = self.body
        if not U.is_asset_valid(b.selling) or not U.is_asset_valid(b.buying):
            return self._res(C["MALFORMED"])
        if U.assets_equal(b.selling, b.buying):
            return self._res(C["MALFORMED"])
        if not _price_valid(b.price) or b.amount <= 0:
            return self._res(C["MALFORMED"])
        return None


class ManageBuyOfferOpFrame(ManageOfferOpFrameBase):
    TYPE = OT.MANAGE_BUY_OFFER
    IS_BUY = True

    def _params(self):
        b = self.body
        # buy offer converts to a sell offer: amount in selling units =
        # ceil(buyAmount * price), stored price inverted
        # (ref ManageBuyOfferOpFrame::getOfferBuyingLiabilities + CAP-0006)
        sell_price = T.Price.make(n=b.price.d, d=b.price.n)
        if b.buyAmount == 0:
            amount = 0
        else:
            amount = big_divide(b.buyAmount, b.price.n, b.price.d, True)
        return (b.selling, b.buying, amount, sell_price, b.offerID)

    def _buy_amount(self) -> int:
        return self.body.buyAmount

    def _result_type(self):
        return T.ManageBuyOfferResult

    def _codes(self):
        E = T.ManageBuyOfferResultCode
        return {
            "MALFORMED": E.MANAGE_BUY_OFFER_MALFORMED,
            "SELL_NO_TRUST": E.MANAGE_BUY_OFFER_SELL_NO_TRUST,
            "BUY_NO_TRUST": E.MANAGE_BUY_OFFER_BUY_NO_TRUST,
            "SELL_NOT_AUTHORIZED": E.MANAGE_BUY_OFFER_SELL_NOT_AUTHORIZED,
            "BUY_NOT_AUTHORIZED": E.MANAGE_BUY_OFFER_BUY_NOT_AUTHORIZED,
            "LINE_FULL": E.MANAGE_BUY_OFFER_LINE_FULL,
            "UNDERFUNDED": E.MANAGE_BUY_OFFER_UNDERFUNDED,
            "CROSS_SELF": E.MANAGE_BUY_OFFER_CROSS_SELF,
            "SELL_NO_ISSUER": E.MANAGE_BUY_OFFER_SELL_NO_ISSUER,
            "BUY_NO_ISSUER": E.MANAGE_BUY_OFFER_BUY_NO_ISSUER,
            "NOT_FOUND": E.MANAGE_BUY_OFFER_NOT_FOUND,
            "LOW_RESERVE": E.MANAGE_BUY_OFFER_LOW_RESERVE,
        }

    def do_check_valid(self, header):
        C = self._codes()
        b = self.body
        if not U.is_asset_valid(b.selling) or not U.is_asset_valid(b.buying):
            return self._res(C["MALFORMED"])
        if U.assets_equal(b.selling, b.buying):
            return self._res(C["MALFORMED"])
        if not _price_valid(b.price) or b.buyAmount < 0 or b.offerID < 0:
            return self._res(C["MALFORMED"])
        if b.buyAmount == 0 and b.offerID == 0:
            return self._res(C["MALFORMED"])
        return None


# -- path payments ------------------------------------------------------------

class PathPaymentStrictReceiveOpFrame(OperationFrame):
    TYPE = OT.PATH_PAYMENT_STRICT_RECEIVE

    def _res(self, code, value=None):
        return op_inner(self.TYPE,
                        T.PathPaymentStrictReceiveResult.make(code, value))

    def do_check_valid(self, header):
        C = T.PathPaymentStrictReceiveResultCode
        b = self.body
        if b.destAmount <= 0 or b.sendMax <= 0:
            return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_MALFORMED)
        for a in [b.sendAsset, b.destAsset, *b.path]:
            if not U.is_asset_valid(a):
                return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.PathPaymentStrictReceiveResultCode
        header = ltx.header()
        b = self.body
        src_id = self.source_account_id()
        dest_id = U.muxed_to_account_id(b.destination)
        if ltx.load_account(dest_id) is None:
            return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION)

        # full conversion chain: send -> path[0] -> ... -> dest
        chain = [b.sendAsset, *b.path, b.destAsset]
        all_atoms: List[object] = []

        # deliver destAmount into dest first (checks trust/capacity)
        if not U.is_native(b.destAsset) and \
                U.asset_issuer(b.destAsset) != dest_id:
            dtl = ltx.load_trustline(dest_id, b.destAsset)
            if dtl is None:
                return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST)
            if not U.is_authorized(dtl.data.value):
                return self._res(
                    C.PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED)

        # walk the chain backwards computing required amounts
        need = b.destAmount
        for i in range(len(chain) - 1, 0, -1):
            buying = chain[i]
            selling = chain[i - 1]
            if U.assets_equal(buying, selling):
                continue
            result, sheep_sent, wheat_recv, atoms = \
                convert_with_offers_and_pools(
                    ltx, header, src_id, selling, INT64_MAX, buying, need,
                    RoundingType.PATH_PAYMENT_STRICT_RECEIVE)
            if result == ConvertResult.CROSSED_SELF:
                return self._res(
                    C.PATH_PAYMENT_STRICT_RECEIVE_OFFER_CROSS_SELF)
            if result == ConvertResult.TOO_MANY_OFFERS:
                from .base import op_error

                return op_error(
                    T.OperationResultCode.opEXCEEDED_WORK_LIMIT)
            if wheat_recv < need:
                return self._res(
                    C.PATH_PAYMENT_STRICT_RECEIVE_TOO_FEW_OFFERS)
            all_atoms = atoms + all_atoms
            need = sheep_sent
        send_amount = need

        if send_amount > b.sendMax:
            return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_OVER_SENDMAX)

        # debit source
        if not U.is_native(b.sendAsset) and \
                U.asset_issuer(b.sendAsset) != src_id:
            stl = ltx.load_trustline(src_id, b.sendAsset)
            if stl is None:
                return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST)
            if not U.is_authorized(stl.data.value):
                return self._res(
                    C.PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED)
        if U.is_native(b.sendAsset):
            src_entry = ltx.load_account(src_id)
            if U.get_available_balance(
                    header, src_entry.data.value) < send_amount:
                return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED)
        if not _credit(ltx, header, src_id, b.sendAsset, -send_amount):
            return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED)
        if not _credit(ltx, header, dest_id, b.destAsset, b.destAmount):
            return self._res(C.PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL)

        success = T.PathPaymentStrictReceiveResult.arms[0][1].make(
            offers=all_atoms,
            last=T.SimplePaymentResult.make(
                destination=T.account_id(dest_id),
                asset=b.destAsset,
                amount=b.destAmount))
        return self._res(
            C.PATH_PAYMENT_STRICT_RECEIVE_SUCCESS, success)


class PathPaymentStrictSendOpFrame(OperationFrame):
    TYPE = OT.PATH_PAYMENT_STRICT_SEND

    def _res(self, code, value=None):
        return op_inner(self.TYPE,
                        T.PathPaymentStrictSendResult.make(code, value))

    def do_check_valid(self, header):
        C = T.PathPaymentStrictSendResultCode
        b = self.body
        if b.sendAmount <= 0 or b.destMin <= 0:
            return self._res(C.PATH_PAYMENT_STRICT_SEND_MALFORMED)
        for a in [b.sendAsset, b.destAsset, *b.path]:
            if not U.is_asset_valid(a):
                return self._res(C.PATH_PAYMENT_STRICT_SEND_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.PathPaymentStrictSendResultCode
        header = ltx.header()
        b = self.body
        src_id = self.source_account_id()
        dest_id = U.muxed_to_account_id(b.destination)
        if ltx.load_account(dest_id) is None:
            return self._res(C.PATH_PAYMENT_STRICT_SEND_NO_DESTINATION)
        if not U.is_native(b.destAsset) and \
                U.asset_issuer(b.destAsset) != dest_id:
            dtl = ltx.load_trustline(dest_id, b.destAsset)
            if dtl is None:
                return self._res(C.PATH_PAYMENT_STRICT_SEND_NO_TRUST)
            if not U.is_authorized(dtl.data.value):
                return self._res(C.PATH_PAYMENT_STRICT_SEND_NOT_AUTHORIZED)
        if not U.is_native(b.sendAsset) and \
                U.asset_issuer(b.sendAsset) != src_id:
            stl = ltx.load_trustline(src_id, b.sendAsset)
            if stl is None:
                return self._res(C.PATH_PAYMENT_STRICT_SEND_SRC_NO_TRUST)
            if not U.is_authorized(stl.data.value):
                return self._res(
                    C.PATH_PAYMENT_STRICT_SEND_SRC_NOT_AUTHORIZED)

        chain = [b.sendAsset, *b.path, b.destAsset]
        all_atoms: List[object] = []
        have = b.sendAmount
        for i in range(len(chain) - 1):
            selling = chain[i]
            buying = chain[i + 1]
            if U.assets_equal(selling, buying):
                continue
            result, sheep_sent, wheat_recv, atoms = \
                convert_with_offers_and_pools(
                    ltx, header, src_id, selling, have, buying, INT64_MAX,
                    RoundingType.PATH_PAYMENT_STRICT_SEND)
            if result == ConvertResult.CROSSED_SELF:
                return self._res(
                    C.PATH_PAYMENT_STRICT_SEND_OFFER_CROSS_SELF)
            if result == ConvertResult.TOO_MANY_OFFERS:
                from .base import op_error

                return op_error(
                    T.OperationResultCode.opEXCEEDED_WORK_LIMIT)
            if sheep_sent < have:
                return self._res(C.PATH_PAYMENT_STRICT_SEND_TOO_FEW_OFFERS)
            all_atoms.extend(atoms)
            have = wheat_recv
        dest_amount = have
        if dest_amount < b.destMin:
            return self._res(C.PATH_PAYMENT_STRICT_SEND_UNDER_DESTMIN)

        if U.is_native(b.sendAsset):
            src_entry = ltx.load_account(src_id)
            if U.get_available_balance(
                    header, src_entry.data.value) < b.sendAmount:
                return self._res(C.PATH_PAYMENT_STRICT_SEND_UNDERFUNDED)
        if not _credit(ltx, header, src_id, b.sendAsset, -b.sendAmount):
            return self._res(C.PATH_PAYMENT_STRICT_SEND_UNDERFUNDED)
        if not _credit(ltx, header, dest_id, b.destAsset, dest_amount):
            return self._res(C.PATH_PAYMENT_STRICT_SEND_LINE_FULL)

        success = T.PathPaymentStrictSendResult.arms[0][1].make(
            offers=all_atoms,
            last=T.SimplePaymentResult.make(
                destination=T.account_id(dest_id),
                asset=b.destAsset,
                amount=dest_amount))
        return self._res(C.PATH_PAYMENT_STRICT_SEND_SUCCESS, success)
