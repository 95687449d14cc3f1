"""Liquidity-pool helpers: pool IDs, pool-share trustlines, constant-product
math (ref src/transactions/TransactionUtils.cpp pool sections,
src/util/numeric128.h bigDivide/bigSquareRoot — exact int arithmetic here,
Python ints replace the reference's int128)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ..crypto import sha256
from ..xdr import types as T
from . import utils as U

INT64_MAX = U.INT64_MAX
ROUND_DOWN = 0
ROUND_UP = 1


def big_divide(a: int, b: int, c: int, rounding: int) -> Optional[int]:
    """floor/ceil of a*b/c with int128-exact semantics; None on overflow
    past INT64_MAX (ref bigDivide, src/util/numeric128.h)."""
    assert c > 0
    x = a * b
    r = x // c if rounding == ROUND_DOWN else -((-x) // c)
    if r > INT64_MAX or r < 0:
        return None
    return r


def big_square_root(a: int, b: int) -> int:
    """floor(sqrt(a*b)) (ref bigSquareRoot)."""
    return math.isqrt(a * b)


def pool_id_from_params(params) -> bytes:
    """PoolID = sha256(XDR(LiquidityPoolParameters))
    (ref TransactionUtils.cpp:1788 xdrSha256(ctAsset.liquidityPool()))."""
    return sha256(T.LiquidityPoolParameters.encode(params))


def compare_assets(a, b) -> int:
    """Total order on Assets: by type, then code, then issuer
    (ref compareAsset)."""
    if a.type != b.type:
        return -1 if a.type < b.type else 1
    if a.type == T.AssetType.ASSET_TYPE_NATIVE:
        return 0
    ca, cb = U.asset_code(a), U.asset_code(b)
    if ca != cb:
        return -1 if ca < cb else 1
    ia, ib = U.asset_issuer(a), U.asset_issuer(b)
    if ia != ib:
        return -1 if ia < ib else 1
    return 0


def pool_share_trustline_key(account_id: bytes, pool_id: bytes):
    arm = T.LedgerKey.arms[T.LedgerEntryType.TRUSTLINE][1].make(
        accountID=T.account_id(account_id),
        asset=T.TrustLineAsset.make(T.AssetType.ASSET_TYPE_POOL_SHARE,
                                    pool_id))
    return T.LedgerKey.make(T.LedgerEntryType.TRUSTLINE, arm)


def pool_key(pool_id: bytes):
    arm = T.LedgerKey.arms[T.LedgerEntryType.LIQUIDITY_POOL][1].make(
        liquidityPoolID=pool_id)
    return T.LedgerKey.make(T.LedgerEntryType.LIQUIDITY_POOL, arm)


def pair_pool_key_bytes(asset_x, asset_y) -> bytes:
    """Canonical pool LedgerKey bytes for the (unordered) classic-asset
    pair.  Shared by the footprint's book materialization and the
    native-apply dispatcher's per-hop pool descriptors: the kernel's
    decline-if-live pool probe must derive the exact key the footprint
    declared, so both sides call THIS function."""
    from ..ledger.ledger_txn import key_bytes

    a, b = ((asset_x, asset_y) if compare_assets(asset_x, asset_y) < 0
            else (asset_y, asset_x))
    params = T.LiquidityPoolParameters.make(
        T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
        T.LiquidityPoolConstantProductParameters.make(
            assetA=a, assetB=b, fee=T.LIQUIDITY_POOL_FEE_V18))
    return key_bytes(pool_key(pool_id_from_params(params)))


def load_pool(ltx, pool_id: bytes):
    return ltx.load(pool_key(pool_id))


def load_pool_share_trustline(ltx, account_id: bytes, pool_id: bytes):
    return ltx.load(pool_share_trustline_key(account_id, pool_id))


def constant_product(pool_entry):
    return pool_entry.data.value.body.value


# -- trustline liquidityPoolUseCount (ext v2) --------------------------------

def tl_pool_use_count(tl) -> int:
    if tl.ext.type == 1 and tl.ext.value.ext.type == 2:
        return tl.ext.value.ext.value.liquidityPoolUseCount
    return 0


_TL_EXT = T.TrustLineEntry.fields[5][1]            # TrustLineEntryExt union
_TL_V1 = _TL_EXT.arms[1][1]                        # TrustLineEntryV1 struct
_TL_V1_EXT = _TL_V1.fields[1][1]                   # TrustLineEntryV1Ext union


def tl_with_pool_use_delta(tl, delta: int):
    """TrustLineEntry value with liquidityPoolUseCount += delta, creating
    the V1/V2 extension chain as needed (ref
    prepareTrustLineEntryExtensionV2)."""
    if tl.ext.type == 0:
        v1 = _TL_V1.make(
            liabilities=T.Liabilities.make(buying=0, selling=0),
            ext=_TL_V1_EXT.make(0))
        tl = tl._replace(ext=_TL_EXT.make(1, v1))
    v1 = tl.ext.value
    if v1.ext.type == 2:
        v2 = v1.ext.value
    else:
        v2 = T.TrustLineEntryExtensionV2.make(
            liquidityPoolUseCount=0,
            ext=T.TrustLineEntryExtensionV2.fields[1][1].make(0))
    n = v2.liquidityPoolUseCount + delta
    if n < 0 or n > 2**31 - 1:
        raise ValueError("liquidityPoolUseCount out of range")
    v1 = v1._replace(ext=_TL_V1_EXT.make(
        2, v2._replace(liquidityPoolUseCount=n)))
    return tl._replace(ext=_TL_EXT.make(1, v1))


# -- pool reserve mutation ---------------------------------------------------

def pool_with_cp(pool_entry, cp):
    lp = pool_entry.data.value._replace(
        body=T.LiquidityPoolEntry.fields[1][1].make(
            T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT, cp))
    return pool_entry._replace(data=T.LedgerEntryData.make(
        T.LedgerEntryType.LIQUIDITY_POOL, lp))


def get_pool_withdrawal_amount(amount: int, total_shares: int,
                               reserve: int) -> int:
    """ref getPoolWithdrawalAmount: amount * reserve / totalShares, floor."""
    r = big_divide(amount, reserve, total_shares, ROUND_DOWN)
    assert r is not None
    return r


# -- constant-product swap (for pool path payments, CAP-38) ------------------

def pool_fee_bps(cp) -> int:
    return cp.params.fee


def swap_out_given_in(reserves_in: int, reserves_out: int, amount_in: int,
                      fee_bps: int) -> Optional[int]:
    """Amount received from the pool for sending amount_in — the
    PATH_PAYMENT_STRICT_SEND arm of ref exchangeWithPool
    (OfferExchange.cpp:1242): out = floor((maxBps-fee) * reservesOut * in /
    (maxBps*reservesIn + (maxBps-fee)*in)); None if the deposit would
    overflow reserves or the floor rounds to zero."""
    if amount_in <= 0 or reserves_in <= 0 or reserves_out <= 0:
        return None
    if amount_in > INT64_MAX - reserves_in:
        return None
    f = 10000 - fee_bps
    out = (f * reserves_out * amount_in) // (
        10000 * reserves_in + f * amount_in)
    if out == 0:
        return None
    return out


def swap_in_given_out(reserves_in: int, reserves_out: int, amount_out: int,
                      fee_bps: int) -> Optional[int]:
    """Amount to send for receiving exactly amount_out — the
    PATH_PAYMENT_STRICT_RECEIVE arm of ref exchangeWithPool:
    in = ceil(maxBps * reservesIn * out / ((reservesOut - out) *
    (maxBps - fee))); None if the pool would be depleted or the required
    deposit overflows reserves."""
    if amount_out <= 0 or reserves_in <= 0 or reserves_out <= 0:
        return None
    if amount_out >= reserves_out:
        return None
    f = 10000 - fee_bps
    num = 10000 * reserves_in * amount_out
    den = (reserves_out - amount_out) * f
    amt = -((-num) // den)  # ceil
    if amt > INT64_MAX - reserves_in:
        return None
    return amt


# -- auth revocation: redeem pool-share trustlines (CAP-38) ------------------

def redeem_pool_share_trustlines(ltx, trustor_id: bytes, asset,
                                 balance_id_for) -> None:
    """Full auth revocation of ``asset``: every pool-share trustline of
    the trustor whose pool contains the asset is redeemed — the share
    balance is withdrawn from the pool and parked in unconditional
    claimable balances for the trustor (ref
    removeOffersAndPoolShareTrustLines + CAP-38,
    src/transactions/TransactionUtils.cpp).

    ``balance_id_for(pool_id, withdrawn_asset) -> bytes32`` derives the
    ClaimableBalanceID from the revoking operation's RevokeID preimage.
    The trustline is removed before the claimable balances are created,
    so the freed 2-subentry reserve covers the new entries."""
    from ..ledger.ledger_txn import entry_to_key
    from . import sponsorship as SP

    prefix = (T.LedgerEntryType.encode(T.LedgerEntryType.TRUSTLINE)
              + T.AccountID.encode(T.account_id(trustor_id)))
    for entry in list(ltx.entries_by_key_prefix(prefix)):
        tl = entry.data.value
        if tl.asset.type != T.AssetType.ASSET_TYPE_POOL_SHARE:
            continue
        pool_id = tl.asset.value
        pool_entry = load_pool(ltx, pool_id)
        if pool_entry is None:
            raise RuntimeError("pool-share trustline without pool")
        cp = constant_product(pool_entry)
        if compare_assets(cp.params.assetA, asset) != 0 and \
                compare_assets(cp.params.assetB, asset) != 0:
            continue

        balance = tl.balance
        amount_a = amount_b = 0
        if balance > 0:
            amount_a = get_pool_withdrawal_amount(
                balance, cp.totalPoolShares, cp.reserveA)
            amount_b = get_pool_withdrawal_amount(
                balance, cp.totalPoolShares, cp.reserveB)

        # the claimable balances inherit the trustline's reserve payer
        # (CAP-38: sponsored by the pool-share trustline's sponsor, else
        # the trustor; created WITHOUT a min-balance check since the
        # trustline's freed reserve covers them)
        tl_sponsor = SP.entry_sponsor(entry)

        # 1. drop the trustline (frees its reserve for the new entries)
        SP.remove_entry_with_possible_sponsorship(ltx, entry, trustor_id)
        ltx.erase(entry_to_key(entry))
        for underlying in (cp.params.assetA, cp.params.assetB):
            if U.is_native(underlying) or \
                    U.asset_issuer(underlying) == trustor_id:
                continue
            utl = ltx.load_trustline(trustor_id, underlying)
            if utl is not None:
                from .operations.base import put_trustline

                put_trustline(ltx, utl,
                              tl_with_pool_use_delta(utl.data.value, -1))

        # 2. shrink the pool
        cp2 = cp._replace(
            reserveA=cp.reserveA - amount_a,
            reserveB=cp.reserveB - amount_b,
            totalPoolShares=cp.totalPoolShares - balance,
            poolSharesTrustLineCount=cp.poolSharesTrustLineCount - 1)
        if cp2.poolSharesTrustLineCount == 0:
            ltx.erase(entry_to_key(pool_entry))
        else:
            ltx.put(pool_with_cp(pool_entry, cp2))

        # 3. park the withdrawn amounts in claimable balances
        for amt, a in ((amount_a, cp.params.assetA),
                       (amount_b, cp.params.assetB)):
            if amt <= 0:
                continue
            clawback = False
            if not U.is_native(a) and U.asset_issuer(a) != trustor_id:
                utl = ltx.load_trustline(trustor_id, a)
                if utl is not None:
                    clawback = U.is_clawback_enabled_tl(utl.data.value)
            bid = T.ClaimableBalanceID.make(
                T.ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
                balance_id_for(pool_id, a))
            if clawback:
                ext = T.ClaimableBalanceEntry.fields[4][1].make(
                    1, T.ClaimableBalanceEntryExtensionV1.make(
                        ext=T.ClaimableBalanceEntryExtensionV1
                        .fields[0][1].make(0),
                        flags=T.CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG))
            else:
                ext = T.ClaimableBalanceEntry.fields[4][1].make(0)
            claimant = T.Claimant.make(
                T.ClaimantType.CLAIMANT_TYPE_V0,
                T.Claimant.arms[T.ClaimantType.CLAIMANT_TYPE_V0][1].make(
                    destination=T.account_id(trustor_id),
                    predicate=T.ClaimPredicate.make(
                        T.ClaimPredicateType
                        .CLAIM_PREDICATE_UNCONDITIONAL)))
            cb = T.ClaimableBalanceEntry.make(
                balanceID=bid, claimants=[claimant], asset=a,
                amount=amt, ext=ext)
            cb_entry = U.wrap_entry(T.LedgerEntryType.CLAIMABLE_BALANCE,
                                    cb)
            sponsor_id = (tl_sponsor if tl_sponsor is not None
                          else trustor_id)
            sp_entry = ltx.load_account(sponsor_id)
            if sp_entry is None:
                raise RuntimeError("revoke sponsor account missing")
            SP._put_account(ltx, sp_entry, SP.add_num_sponsoring(
                sp_entry.data.value, 1))
            cb_entry = SP.set_entry_sponsor(cb_entry, sponsor_id)
            ltx.put(cb_entry)
