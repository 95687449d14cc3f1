"""OfferExchange: the DEX engine — order-book crossing with the protocol's
rounding-fairness rules (ref src/transactions/OfferExchange.{h,cpp}; design
essay at OfferExchange.h:87-163).

All the reference's uint128 intermediate math is exact Python int here —
the bit-identical-results requirement (SURVEY.md §7 "hard parts") keeps
this on host CPU, never on device.

LOCKSTEP NOTE: ``native/apply_kernel.cpp`` mirrors this module's
success-path arithmetic (exchangeV10 with/without thresholds,
adjustOffer, offer liabilities, the crossing loop) in 64/128-bit C for
the GIL-free apply kernel.  Behavioral changes here MUST be ported
there; the kernel's protocol constants are asserted against this
module's at dispatch time (apply/native_apply.py
``_constants_in_lockstep``) and any divergence disables the kernel
rather than risking a fork.
tests/test_native_apply.py holds the bit-identity property.

Terminology follows the reference: the book offer sells WHEAT and buys
SHEEP at ``price`` = sheep-per-wheat (price.n/price.d); the taker sends
sheep and receives wheat.
"""
from __future__ import annotations

from enum import Enum
from typing import Callable, List, Optional, Tuple

from ..xdr import types as T
from . import utils as U

INT64_MAX = U.INT64_MAX


class RoundingType(Enum):
    NORMAL = 0
    PATH_PAYMENT_STRICT_RECEIVE = 1
    PATH_PAYMENT_STRICT_SEND = 2


class ExchangeError(Exception):
    pass


def big_divide(a: int, b: int, c: int, round_up: bool) -> int:
    """floor/ceil of a*b/c with int64 overflow check
    (ref bigDivideOrThrow)."""
    x = a * b
    res = -((-x) // c) if round_up else x // c
    if res > INT64_MAX or res < 0:
        raise ExchangeError("int64 overflow in division")
    return res


def _div128(x: int, c: int, round_up: bool) -> int:
    res = -((-x) // c) if round_up else x // c
    if res > INT64_MAX or res < 0:
        raise ExchangeError("int64 overflow in division")
    return res


def calculate_offer_value(price_n: int, price_d: int, max_send: int,
                          max_receive: int) -> int:
    """min(maxSend*priceN, maxReceive*priceD)
    (ref calculateOfferValue :219)."""
    return min(max_send * price_n, max_receive * price_d)


class ExchangeResultV10:
    __slots__ = ("num_wheat_received", "num_sheep_send", "wheat_stays")

    def __init__(self, wheat_receive: int, sheep_send: int,
                 wheat_stays: bool):
        self.num_wheat_received = wheat_receive
        self.num_sheep_send = sheep_send
        self.wheat_stays = wheat_stays


def _exchange_v10_without_thresholds(
        price, max_wheat_send: int, max_wheat_receive: int,
        max_sheep_send: int, max_sheep_receive: int,
        round_: RoundingType) -> ExchangeResultV10:
    """ref exchangeV10WithoutPriceErrorThresholds :631."""
    wheat_value = calculate_offer_value(
        price.n, price.d, max_wheat_send, max_sheep_receive)
    sheep_value = calculate_offer_value(
        price.d, price.n, max_sheep_send, max_wheat_receive)
    wheat_stays = wheat_value > sheep_value

    if wheat_stays:
        if round_ == RoundingType.PATH_PAYMENT_STRICT_SEND:
            wheat_receive = _div128(sheep_value, price.n, False)
            sheep_send = min(max_sheep_send, max_sheep_receive)
        elif price.n > price.d or \
                round_ == RoundingType.PATH_PAYMENT_STRICT_RECEIVE:
            wheat_receive = _div128(sheep_value, price.n, False)
            sheep_send = big_divide(wheat_receive, price.n, price.d, True)
        else:  # sheep is more valuable
            sheep_send = _div128(sheep_value, price.d, False)
            wheat_receive = big_divide(sheep_send, price.d, price.n, False)
    else:
        if price.n > price.d:  # wheat is more valuable
            wheat_receive = _div128(wheat_value, price.n, False)
            sheep_send = big_divide(wheat_receive, price.n, price.d, False)
        else:
            sheep_send = _div128(wheat_value, price.d, False)
            wheat_receive = big_divide(sheep_send, price.d, price.n, True)

    if wheat_receive < 0 or \
            wheat_receive > min(max_wheat_receive, max_wheat_send):
        raise ExchangeError("wheatReceive out of bounds")
    if sheep_send < 0 or sheep_send > min(max_sheep_receive, max_sheep_send):
        raise ExchangeError("sheepSend out of bounds")
    return ExchangeResultV10(wheat_receive, sheep_send, wheat_stays)


def check_price_error_bound(price, wheat_receive: int, sheep_send: int,
                            can_favor_wheat: bool) -> bool:
    """Relative price error <= 1% (ref checkPriceErrorBound :187)."""
    lhs = 100 * price.n * wheat_receive
    rhs = 100 * price.d * sheep_send
    if can_favor_wheat and rhs > lhs:
        return True
    abs_diff = abs(lhs - rhs)
    cap = price.n * wheat_receive
    return abs_diff <= cap


def _apply_price_error_thresholds(price, wheat_receive: int,
                                  sheep_send: int, wheat_stays: bool,
                                  round_: RoundingType) -> ExchangeResultV10:
    """ref applyPriceErrorThresholds :702."""
    if wheat_receive > 0 and sheep_send > 0:
        wheat_receive_value = wheat_receive * price.n
        sheep_send_value = sheep_send * price.d
        if wheat_stays and sheep_send_value < wheat_receive_value:
            raise ExchangeError("favored sheep when wheat stays")
        if not wheat_stays and sheep_send_value > wheat_receive_value:
            raise ExchangeError("favored wheat when sheep stays")
        if round_ == RoundingType.NORMAL:
            if not check_price_error_bound(
                    price, wheat_receive, sheep_send, False):
                sheep_send = 0
                wheat_receive = 0
        else:
            if not check_price_error_bound(
                    price, wheat_receive, sheep_send, True):
                raise ExchangeError("exceeded price error bound")
    else:
        if round_ == RoundingType.PATH_PAYMENT_STRICT_SEND:
            if sheep_send == 0:
                raise ExchangeError("invalid amount of sheep sent")
        else:
            wheat_receive = 0
            sheep_send = 0
    return ExchangeResultV10(wheat_receive, sheep_send, wheat_stays)


def exchange_v10(price, max_wheat_send: int, max_wheat_receive: int,
                 max_sheep_send: int, max_sheep_receive: int,
                 round_: RoundingType = RoundingType.NORMAL
                 ) -> ExchangeResultV10:
    """ref exchangeV10 :551."""
    before = _exchange_v10_without_thresholds(
        price, max_wheat_send, max_wheat_receive, max_sheep_send,
        max_sheep_receive, round_)
    return _apply_price_error_thresholds(
        price, before.num_wheat_received, before.num_sheep_send,
        before.wheat_stays, round_)


def adjust_offer_amount(price, max_wheat_send: int,
                        max_sheep_receive: int) -> int:
    """Largest effectively-executable offer amount given seller capacity
    (ref adjustOffer :784): run exchangeV10 against an unbounded taker and
    keep what would actually trade."""
    res = exchange_v10(price, max_wheat_send, INT64_MAX, INT64_MAX,
                       max_sheep_receive, RoundingType.NORMAL)
    return res.num_wheat_received


# -- offer liabilities (ref getOfferBuyingLiabilities / Selling) -------------

def offer_selling_liabilities(price, amount: int) -> int:
    res = _exchange_v10_without_thresholds(
        price, amount, INT64_MAX, INT64_MAX, INT64_MAX,
        RoundingType.NORMAL)
    return res.num_wheat_received


def offer_buying_liabilities(price, amount: int) -> int:
    res = _exchange_v10_without_thresholds(
        price, amount, INT64_MAX, INT64_MAX, INT64_MAX,
        RoundingType.NORMAL)
    return res.num_sheep_send


def apply_offer_liabilities(ltx, oe, sign: int) -> bool:
    """Acquire (sign=+1) or release (-1) a resting offer's liabilities
    on the owner's account / trustlines (ref acquireLiabilities /
    releaseLiabilities, src/transactions/TransactionUtils.cpp:100-190).

    Acquire enforces the balance/limit headroom bounds and returns False
    when the offer does not fit (callers size offers so that cannot
    happen).  A failing RELEASE means the ledger is already corrupt
    (liabilities without a holder) and raises at the point of corruption
    like the reference, rather than desyncing silently.  Issuer sides
    carry no liabilities."""
    from .operations.base import put_account, put_trustline

    def fail(reason: str) -> bool:
        if sign < 0:
            raise ExchangeError(f"liability release failed: {reason}")
        return False

    seller = oe.sellerID.value
    header = ltx.header()
    for asset, is_buy in ((oe.selling, False), (oe.buying, True)):
        liab = (offer_buying_liabilities(oe.price, oe.amount) if is_buy
                else offer_selling_liabilities(oe.price, oe.amount))
        delta = sign * liab
        if delta == 0:
            continue
        if U.is_native(asset):
            entry = ltx.load_account(seller)
            if entry is None:
                return fail("owner account missing")
            acc = entry.data.value
            b, s = U.account_liabilities(acc)
            if is_buy:
                b += delta
                if b < 0 or (sign > 0 and b > U.INT64_MAX - acc.balance):
                    return fail("buying liabilities out of bounds")
            else:
                s += delta
                if s < 0 or (sign > 0 and
                             s > acc.balance - U.min_balance(header, acc)):
                    return fail("selling liabilities out of bounds")
            put_account(ltx, entry, U.set_account_liabilities(acc, b, s))
        elif U.asset_issuer(asset) == seller:
            continue
        else:
            tl_entry = ltx.load_trustline(seller, asset)
            if tl_entry is None:
                return fail("owner trustline missing")
            tl = tl_entry.data.value
            b, s = U.trustline_liabilities(tl)
            if is_buy:
                b += delta
                if b < 0 or (sign > 0 and b > tl.limit - tl.balance):
                    return fail("buying liabilities out of bounds")
            else:
                s += delta
                if s < 0 or (sign > 0 and s > tl.balance):
                    return fail("selling liabilities out of bounds")
            put_trustline(ltx, tl_entry,
                          U.set_trustline_liabilities(tl, b, s))
    return True


# -- seller capacity (ref canSellAtMost / canBuyAtMost :55-107) ---------------

def can_sell_at_most(header, ltx, account_id: bytes, asset) -> int:
    if U.is_native(asset):
        entry = ltx.load_account(account_id)
        if entry is None:
            return 0
        return U.get_available_balance(header, entry.data.value)
    if U.asset_issuer(asset) == account_id:
        return INT64_MAX
    tl_entry = ltx.load_trustline(account_id, asset)
    if tl_entry is None:
        return 0
    tl = tl_entry.data.value
    if not U.is_authorized(tl):
        return 0
    return U.trustline_available_balance(tl)


def can_buy_at_most(header, ltx, account_id: bytes, asset) -> int:
    if U.is_native(asset):
        entry = ltx.load_account(account_id)
        if entry is None:
            return 0
        return max(0, U.get_max_receive(header, entry.data.value))
    if U.asset_issuer(asset) == account_id:
        return INT64_MAX
    tl_entry = ltx.load_trustline(account_id, asset)
    if tl_entry is None:
        return 0
    tl = tl_entry.data.value
    if not U.is_authorized(tl):
        return 0
    return max(0, U.trustline_max_receive(tl))


# -- balance transfer helpers ------------------------------------------------

def _credit(ltx, header, account_id: bytes, asset, delta: int) -> bool:
    """Add ``delta`` (may be negative) of asset to the account; False on
    capacity violation."""
    from .operations.base import put_account, put_trustline

    if U.is_native(asset):
        entry = ltx.load_account(account_id)
        if entry is None:
            return False
        acc = entry.data.value
        buying, selling = U.account_liabilities(acc)
        nb = acc.balance + delta
        # liabilities-aware bounds (ref addBalance for accounts:
        # [selling, INT64_MAX - buying]; reserve is the caller's check)
        if nb < selling or nb > U.INT64_MAX - buying:
            return False
        put_account(ltx, entry, acc._replace(balance=nb))
        return True
    if U.asset_issuer(asset) == account_id:
        return True  # issuers mint/burn freely
    tl_entry = ltx.load_trustline(account_id, asset)
    if tl_entry is None:
        return False
    tl = tl_entry.data.value
    buying, selling = U.trustline_liabilities(tl)
    nb = tl.balance + delta
    if nb < selling or nb > tl.limit - buying:
        return False
    put_trustline(ltx, tl_entry, tl._replace(balance=nb))
    return True


# -- the crossing loop --------------------------------------------------------

class ConvertResult(Enum):
    OK = 0
    PARTIAL = 1           # stopped (no more offers / limit) before filled
    FILTER_STOP = 2       # price filter stopped crossing
    CROSSED_SELF = 3
    TOO_MANY_OFFERS = 4


def convert_with_offers(
    ltx, header, source_id: bytes,
    sheep, max_sheep_send: int,
    wheat, max_wheat_receive: int,
    round_: RoundingType,
    price_filter: Optional[Callable] = None,
) -> Tuple[ConvertResult, int, int, List[object]]:
    """Cross book offers selling ``wheat`` for ``sheep`` until limits are
    exhausted (ref convertWithOffersAndPools :316 / crossOfferV10).

    price_filter(offer_entry) -> False stops crossing (the manage-offer
    own-price bound).  Returns (result, sheep_sent, wheat_received,
    claim_atoms).  Balance effects for the SOURCE side are left to the
    caller; book sellers are debited/credited here.
    """
    sheep_b = T.Asset.encode(sheep)
    wheat_b = T.Asset.encode(wheat)
    sheep_sent = 0
    wheat_received = 0
    atoms: List[object] = []
    crossed = 0

    while max_sheep_send - sheep_sent > 0 and \
            max_wheat_receive - wheat_received > 0:
        entry = ltx.best_offer(wheat_b, sheep_b)
        if entry is None:
            break
        if crossed >= U.MAX_OFFERS_TO_CROSS:
            return (ConvertResult.TOO_MANY_OFFERS, sheep_sent,
                    wheat_received, atoms)
        oe = entry.data.value
        if price_filter is not None and not price_filter(oe):
            return (ConvertResult.FILTER_STOP, sheep_sent,
                    wheat_received, atoms)
        seller_id = oe.sellerID.value
        if seller_id == source_id:
            return (ConvertResult.CROSSED_SELF, sheep_sent,
                    wheat_received, atoms)

        # free the book offer's own reservation before measuring the
        # seller's capacity (ref crossOfferV10: releaseLiabilities first)
        apply_offer_liabilities(ltx, oe, -1)

        # seller capacity (ref crossOfferV10 :791-792)
        max_wheat_send_offer = min(
            oe.amount, can_sell_at_most(header, ltx, seller_id, wheat))
        max_sheep_receive_offer = can_buy_at_most(
            header, ltx, seller_id, sheep)
        adjusted = adjust_offer_amount(
            oe.price, max_wheat_send_offer, max_sheep_receive_offer)
        if adjusted == 0:
            _erase_offer(ltx, entry)
            crossed += 1
            continue

        res = exchange_v10(
            oe.price, adjusted, max_wheat_receive - wheat_received,
            max_sheep_send - sheep_sent, INT64_MAX, round_)
        crossed += 1

        if res.num_wheat_received > 0:
            # move assets on the seller side
            ok1 = _credit(ltx, header, seller_id, wheat,
                          -res.num_wheat_received)
            ok2 = _credit(ltx, header, seller_id, sheep,
                          res.num_sheep_send)
            if not (ok1 and ok2):
                raise ExchangeError("seller balance transfer failed")
            atoms.append(T.ClaimAtom.make(
                T.ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK,
                T.ClaimOfferAtom.make(
                    sellerID=oe.sellerID,
                    offerID=oe.offerID,
                    assetSold=wheat,
                    amountSold=res.num_wheat_received,
                    assetBought=sheep,
                    amountBought=res.num_sheep_send)))
            sheep_sent += res.num_sheep_send
            wheat_received += res.num_wheat_received

        if res.wheat_stays:
            # offer remains: shrink + re-adjust + re-reserve
            new_amount = adjust_offer_amount(
                oe.price,
                min(oe.amount - res.num_wheat_received,
                    can_sell_at_most(header, ltx, seller_id, wheat)),
                can_buy_at_most(header, ltx, seller_id, sheep))
            if new_amount == 0:
                _erase_offer(ltx, entry)
            else:
                oe2 = oe._replace(amount=new_amount)
                ltx.put(entry._replace(data=T.LedgerEntryData.make(
                    T.LedgerEntryType.OFFER, oe2)))
                if not apply_offer_liabilities(ltx, oe2, 1):
                    raise ExchangeError(
                        "residual offer liabilities do not fit")
            break  # taker exhausted
        else:
            _erase_offer(ltx, entry)

    if max_wheat_receive - wheat_received > 0 and \
            max_sheep_send - sheep_sent > 0:
        return (ConvertResult.PARTIAL, sheep_sent, wheat_received, atoms)
    return (ConvertResult.OK, sheep_sent, wheat_received, atoms)


def _erase_offer(ltx, entry) -> None:
    """Remove an offer + its reserve accounting (subentry count and any
    sponsorship).  The offer's liabilities must already have been
    released."""
    from ..ledger.ledger_txn import entry_to_key
    from . import sponsorship as SP

    ltx.erase(entry_to_key(entry))
    SP.remove_entry_with_possible_sponsorship(
        ltx, entry, entry.data.value.sellerID.value)


def _delete_offer(ltx, entry) -> None:
    """Release a resting offer's liabilities, then remove it (ref
    eraseOfferWithPossibleSponsorship after releaseLiabilities)."""
    apply_offer_liabilities(ltx, entry.data.value, -1)
    _erase_offer(ltx, entry)


def remove_offers_by_account_and_asset(ltx, account_id: bytes,
                                       asset) -> None:
    """Delete every offer of the account that buys or sells ``asset``,
    releasing liabilities and subentry counts (ref
    removeOffersByAccountAndAsset, TransactionUtils.cpp — run when
    trustline authorization is fully revoked)."""
    enc = T.Asset.encode(asset)
    for entry in ltx.offers_by_account(account_id):
        o = entry.data.value
        if T.Asset.encode(o.selling) == enc or \
                T.Asset.encode(o.buying) == enc:
            _delete_offer(ltx, entry)


# ---------------------------------------------------------------------------
# pools in the path (ref convertWithOffersAndPools :316 + exchangeWithPool
# :1242 + shouldConvertWithOffers :1617)
# ---------------------------------------------------------------------------

def _pool_exchange_quote(ltx, sheep, wheat, max_sheep_send: int,
                         max_wheat_receive: int, round_: RoundingType):
    """(to_pool, from_pool, pool_entry, cp, sheep_is_a) or None if the
    pool can't do this exchange (absent, depleted, overflow, zero out)."""
    from . import liquidity_pool as LP

    sheep_is_a = LP.compare_assets(sheep, wheat) < 0
    a, b = (sheep, wheat) if sheep_is_a else (wheat, sheep)
    params = T.LiquidityPoolParameters.make(
        T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
        T.LiquidityPoolConstantProductParameters.make(
            assetA=a, assetB=b, fee=T.LIQUIDITY_POOL_FEE_V18))
    pool_id = LP.pool_id_from_params(params)
    pool_entry = LP.load_pool(ltx, pool_id)
    if pool_entry is None:
        return None
    cp = LP.constant_product(pool_entry)
    reserves_in = cp.reserveA if sheep_is_a else cp.reserveB
    reserves_out = cp.reserveB if sheep_is_a else cp.reserveA
    if reserves_in <= 0 or reserves_out <= 0:
        return None
    fee = cp.params.fee
    if round_ == RoundingType.PATH_PAYMENT_STRICT_SEND:
        to_pool = max_sheep_send
        from_pool = LP.swap_out_given_in(reserves_in, reserves_out,
                                         to_pool, fee)
        if from_pool is None:
            return None
    elif round_ == RoundingType.PATH_PAYMENT_STRICT_RECEIVE:
        from_pool = max_wheat_receive
        to_pool = LP.swap_in_given_out(reserves_in, reserves_out,
                                       from_pool, fee)
        if to_pool is None:
            return None
    else:
        return None  # pools only participate in path payments
    return to_pool, from_pool, pool_entry, cp, sheep_is_a


def convert_with_offers_and_pools(
    ltx, header, source_id: bytes,
    sheep, max_sheep_send: int,
    wheat, max_wheat_receive: int,
    round_: RoundingType,
    price_filter: Optional[Callable] = None,
) -> Tuple[ConvertResult, int, int, List[object]]:
    """One path-payment hop: use the liquidity pool unless the order book
    gives a strictly better price (ref convertWithOffersAndPools +
    shouldConvertWithOffers — 'use the pool unless the book is strictly
    better').

    The book attempt runs in a child LedgerTxn that commits only when the
    book wins; the pool exchange mutates the pool reserves and yields one
    CLAIM_ATOM_TYPE_LIQUIDITY_POOL atom."""
    from ..ledger.ledger_txn import LedgerTxn
    from . import liquidity_pool as LP

    quote = _pool_exchange_quote(ltx, sheep, wheat, max_sheep_send,
                                 max_wheat_receive, round_)

    with LedgerTxn(ltx) as book_ltx:
        result, sheep_sent, wheat_recv, atoms = convert_with_offers(
            book_ltx, header, source_id, sheep, max_sheep_send,
            wheat, max_wheat_receive, round_, price_filter)
        use_book = True
        if quote is not None:
            to_pool, from_pool, _, _, _ = quote
            if result != ConvertResult.OK:
                use_book = False
            else:
                # book wins only at a strictly better price:
                # poolSend * bookRecv > poolRecv * bookSend
                use_book = (to_pool * wheat_recv >
                            from_pool * sheep_sent)
        if use_book:
            book_ltx.commit()
            return result, sheep_sent, wheat_recv, atoms
        book_ltx.rollback()

    # pool path: apply the swap to the reserves
    to_pool, from_pool, pool_entry, cp, sheep_is_a = quote
    if sheep_is_a:
        cp = cp._replace(reserveA=cp.reserveA + to_pool,
                         reserveB=cp.reserveB - from_pool)
    else:
        cp = cp._replace(reserveB=cp.reserveB + to_pool,
                         reserveA=cp.reserveA - from_pool)
    ltx.put(LP.pool_with_cp(pool_entry, cp))
    atom = T.ClaimAtom.make(
        T.ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL,
        T.ClaimLiquidityAtom.make(
            liquidityPoolID=pool_entry.data.value.liquidityPoolID,
            assetSold=wheat, amountSold=from_pool,
            assetBought=sheep, amountBought=to_pool))
    return ConvertResult.OK, to_pool, from_pool, [atom]
