"""Invariant framework: pluggable post-condition checkers run on apply
(ref src/invariant — SURVEY.md §2.13).

A failed strict invariant raises InvariantDoesNotHold => node crash
(safety-first, like the reference).  Registered by config regex.
"""
from __future__ import annotations

import re
from typing import List

from ..transactions import utils as U
from ..xdr import types as T


class InvariantDoesNotHold(Exception):
    pass


class Invariant:
    NAME = "invariant"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        """Return '' when the invariant holds, else a description."""
        return ""


def entry_validity_error(entry) -> str:
    """Structural validity of one ledger entry — shared by the tx-apply
    and bucket-apply paths (ref LedgerEntryIsValid.cpp checks)."""
    d = entry.data
    if d.type == T.LedgerEntryType.ACCOUNT:
        acc = d.value
        if acc.balance < 0:
            return f"account balance negative: {acc.balance}"
        if acc.seqNum < 0:
            return "account seqnum negative"
        if len(acc.signers) > T.MAX_SIGNERS:
            return "too many signers"
    elif d.type == T.LedgerEntryType.TRUSTLINE:
        tl = d.value
        if tl.balance < 0 or tl.balance > tl.limit:
            return "trustline balance out of [0, limit]"
    elif d.type == T.LedgerEntryType.OFFER:
        off = d.value
        if off.amount <= 0:
            return "offer amount non-positive"
        if off.price.n <= 0 or off.price.d <= 0:
            return "offer price non-positive"
    return ""


class LedgerEntryIsValid(Invariant):
    """Structural validity of touched entries
    (ref src/invariant/LedgerEntryIsValid.cpp)."""

    NAME = "LedgerEntryIsValid"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        for kb, entry in ltx._delta.items():
            if entry is None or kb.startswith(b"\xff"):
                continue  # erased / virtual sponsorship bookkeeping
            msg = entry_validity_error(entry)
            if msg:
                return msg
        return ""


def _native_amount(entry) -> int:
    """Native lumens held by a ledger entry: account balances, native
    claimable balances, and native liquidity-pool reserves (ref
    ConservationOfLumens.cpp ledgerEntryCoinDiff covering all types)."""
    if entry is None:
        return 0
    d = entry.data
    LE = T.LedgerEntryType
    if d.type == LE.ACCOUNT:
        return d.value.balance
    if d.type == LE.CLAIMABLE_BALANCE:
        if d.value.asset.type == T.AssetType.ASSET_TYPE_NATIVE:
            return d.value.amount
        return 0
    if d.type == LE.LIQUIDITY_POOL:
        cp = d.value.body.value
        total = 0
        if cp.params.assetA.type == T.AssetType.ASSET_TYPE_NATIVE:
            total += cp.reserveA
        if cp.params.assetB.type == T.AssetType.ASSET_TYPE_NATIVE:
            total += cp.reserveB
        return total
    return 0


class ConservationOfLumens(Invariant):
    """Native lumens only move, never appear (ref
    src/invariant/ConservationOfLumens.cpp): per-tx delta of native-
    holding entries + feePool must equal the totalCoins delta."""

    NAME = "ConservationOfLumens"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        delta = 0
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff"):
                continue  # virtual sponsorship bookkeeping
            delta += _native_amount(entry) - _native_amount(
                ltx.parent.get(kb))
        hdr_new = ltx.header()
        hdr_old = ltx.parent.header()
        delta += hdr_new.feePool - hdr_old.feePool
        delta -= hdr_new.totalCoins - hdr_old.totalCoins
        if delta != 0:
            return f"lumens not conserved: delta {delta}"
        return ""


class AccountSubEntriesCountIsValid(Invariant):
    """numSubEntries tracks signers + owned subentry deltas
    (ref src/invariant/AccountSubEntriesCountIsValid.cpp)."""

    NAME = "AccountSubEntriesCountIsValid"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        LE = T.LedgerEntryType
        sub_delta: dict = {}
        signer_delta: dict = {}
        count_delta: dict = {}
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff"):
                continue
            old = ltx.parent.get(kb)
            for e, sign in ((entry, 1), (old, -1)):
                if e is None:
                    continue
                d = e.data
                if d.type == LE.ACCOUNT:
                    aid = d.value.accountID.value
                    count_delta[aid] = count_delta.get(aid, 0) + \
                        sign * d.value.numSubEntries
                    signer_delta[aid] = signer_delta.get(aid, 0) + \
                        sign * len(d.value.signers)
                elif d.type == LE.TRUSTLINE:
                    aid = d.value.accountID.value
                    mult = 2 if d.value.asset.type == \
                        T.AssetType.ASSET_TYPE_POOL_SHARE else 1
                    sub_delta[aid] = sub_delta.get(aid, 0) + sign * mult
                elif d.type == LE.OFFER:
                    aid = d.value.sellerID.value
                    sub_delta[aid] = sub_delta.get(aid, 0) + sign
                elif d.type == LE.DATA:
                    aid = d.value.accountID.value
                    sub_delta[aid] = sub_delta.get(aid, 0) + sign
        for aid, cd in count_delta.items():
            expect = sub_delta.get(aid, 0) + signer_delta.get(aid, 0)
            # deleted accounts (merge) drop their remaining count wholesale
            if ltx.get(_account_kb(aid)) is None:
                continue
            if cd != expect:
                return (f"numSubEntries delta {cd} != owned subentry "
                        f"delta {expect} for {aid[:4].hex()}")
        return ""


class SponsorshipCountIsValid(Invariant):
    """Sum of numSponsoring deltas == sum of sponsored-reserve deltas
    (entry sponsorships + account numSponsored; ref
    src/invariant/SponsorshipCountIsValid.cpp)."""

    NAME = "SponsorshipCountIsValid"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        from ..transactions.sponsorship import compute_multiplier, \
            entry_sponsor

        sponsoring = 0
        sponsored_accounts = 0
        entry_reserves = 0
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff"):
                continue
            old = ltx.parent.get(kb)
            for e, sign in ((entry, 1), (old, -1)):
                if e is None:
                    continue
                if e.data.type == T.LedgerEntryType.ACCOUNT:
                    sponsoring += sign * U.num_sponsoring(e.data.value)
                    sponsored_accounts += sign * U.num_sponsored(
                        e.data.value)
                if entry_sponsor(e) is not None:
                    if e.data.type == T.LedgerEntryType.ACCOUNT:
                        pass  # account entries count via numSponsored
                    elif e.data.type == T.LedgerEntryType.CLAIMABLE_BALANCE:
                        entry_reserves += sign * compute_multiplier(e)
        if sponsoring != sponsored_accounts + entry_reserves:
            return (f"numSponsoring delta {sponsoring} != numSponsored "
                    f"{sponsored_accounts} + claimable-balance reserves "
                    f"{entry_reserves}")
        return ""


class ConstantProductInvariant(Invariant):
    """Pool invariant k = reserveA*reserveB never decreases across a swap
    and reserves stay nonnegative (ref
    src/invariant/ConstantProductInvariant.cpp)."""

    NAME = "ConstantProductInvariant"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff") or entry is None:
                continue
            if entry.data.type != T.LedgerEntryType.LIQUIDITY_POOL:
                continue
            cp = entry.data.value.body.value
            if cp.reserveA < 0 or cp.reserveB < 0 or \
                    cp.totalPoolShares < 0:
                return "negative pool reserve/shares"
            old = ltx.parent.get(kb)
            if old is None:
                continue
            ocp = old.data.value.body.value
            # deposits/withdraws change totalPoolShares; swaps keep it —
            # for swaps k must not decrease
            if cp.totalPoolShares == ocp.totalPoolShares and \
                    ocp.totalPoolShares != 0:
                if cp.reserveA * cp.reserveB < ocp.reserveA * ocp.reserveB:
                    return "constant product decreased on swap"
        return ""


class OrderBookIsNotCrossed(Invariant):
    """After any op touching offers, no asset pair's book may hold an
    EXECUTABLE cross: best A->B and best B->A offers whose prices cross
    (p_fwd * p_rev < 1) AND that exchangeV10 would actually trade (ref
    src/invariant/OrderBookIsNotCrossed.cpp; acceptance-time tests only
    in the reference, always-on here).

    The executability refinement is load-bearing: exchangeV10's 1%
    price-error bound refuses micro trades as (0, 0) — e.g. 11 units
    against a 92/100 offer rounds to an 8.7% price error — so a small
    taker remainder can legitimately REST at a price that technically
    crosses the book.  The reference permits that dust state too (its
    invariant only runs in curated acceptance tests); flagging it here
    would fault closes the engine is required to accept."""

    NAME = "OrderBookIsNotCrossed"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        from ..transactions.offer_exchange import (
            ExchangeError, INT64_MAX, RoundingType, exchange_v10,
        )

        pairs = set()
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff"):
                continue
            for e in (entry, ltx.parent.get(kb)):
                if e is not None and \
                        e.data.type == T.LedgerEntryType.OFFER:
                    o = e.data.value
                    pairs.add((T.Asset.encode(o.selling),
                               T.Asset.encode(o.buying)))
        for selling, buying in pairs:
            fwd = ltx.best_offer(selling, buying)
            rev = ltx.best_offer(buying, selling)
            if fwd is None or rev is None:
                continue
            fo, ro = fwd.data.value, rev.data.value
            # price-crossed iff p_fwd * p_rev < 1
            if fo.price.n * ro.price.n >= fo.price.d * ro.price.d:
                continue

            # the engine only ever executes taker-vs-book, so this
            # state is legally reachable iff at least one orientation's
            # exchange REFUSES (the refused side was the taker and
            # rested); flag only when BOTH orientations would trade —
            # then whichever offer came second must have crossed
            def trades(book, taker) -> bool:
                try:
                    res = exchange_v10(book.price, book.amount,
                                       INT64_MAX, taker.amount,
                                       INT64_MAX, RoundingType.NORMAL)
                    return res.num_wheat_received > 0 and \
                        res.num_sheep_send > 0
                except ExchangeError:
                    return False

            if trades(fo, ro) and trades(ro, fo):
                return (f"book crossed: {fo.price.n}/{fo.price.d} x "
                        f"{ro.price.n}/{ro.price.d} < 1 and executable "
                        f"both ways ({fo.amount} vs {ro.amount})")
        return ""


class LiabilitiesMatchOffers(Invariant):
    """Liabilities stay in sync with the offer book, and balances/limits
    respect liabilities and reserve (ref
    src/invariant/LiabilitiesMatchOffers.cpp).

    Two checks per applied operation:
    1. delta sync: summed offer buying/selling liabilities per
       (account, asset) must move exactly with the account/trustline
       liability fields;
    2. bound checks on entries whose balance decreased or liabilities
       increased: account balance - selling >= minBalance,
       INT64_MAX - balance >= buying; trustline selling <= balance,
       buying <= limit - balance; unauthorized trustlines hold zero
       liabilities.
    """

    NAME = "LiabilitiesMatchOffers"

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> str:
        from ..transactions.offer_exchange import (
            offer_buying_liabilities, offer_selling_liabilities,
        )

        LE = T.LedgerEntryType
        native = T.Asset.encode(U.asset_native())
        delta: dict = {}  # (accountID, asset bytes) -> [buying, selling]

        def bump(aid, asset, buying, selling, sign):
            key = (aid, asset)
            cur = delta.setdefault(key, [0, 0])
            cur[0] += sign * buying
            cur[1] += sign * selling

        header = ltx.header()
        for kb, entry in ltx._delta.items():
            if kb.startswith(b"\xff"):
                continue
            old = ltx.parent.get(kb)
            for e, sign in ((entry, 1), (old, -1)):
                if e is None:
                    continue
                d = e.data
                if d.type == LE.OFFER:
                    o = d.value
                    aid = o.sellerID.value
                    # issuer sides carry no liabilities (mirrors
                    # apply_offer_liabilities / ref addOrSubtract...)
                    if U.asset_issuer(o.buying) != aid:
                        bump(aid, T.Asset.encode(o.buying),
                             offer_buying_liabilities(o.price, o.amount),
                             0, sign)
                    if U.asset_issuer(o.selling) != aid:
                        bump(aid, T.Asset.encode(o.selling), 0,
                             offer_selling_liabilities(o.price, o.amount),
                             sign)
                elif d.type == LE.ACCOUNT:
                    b, s = U.account_liabilities(d.value)
                    bump(d.value.accountID.value, native, b, s, -sign)
                elif d.type == LE.TRUSTLINE:
                    tl = d.value
                    if tl.asset.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
                        continue  # pool shares carry no offer liabilities
                    b, s = U.trustline_liabilities(tl)
                    bump(tl.accountID.value,
                         T.TrustLineAsset.encode(tl.asset), b, s, -sign)
            # bound checks on the post-state only
            if entry is None:
                continue
            d = entry.data
            if d.type == LE.ACCOUNT:
                acc = d.value
                buying, selling = U.account_liabilities(acc)
                old_b, old_s = (U.account_liabilities(old.data.value)
                                if old is not None else (0, 0))
                went_down = old is not None and \
                    acc.balance < old.data.value.balance
                if went_down or buying > old_b or selling > old_s:
                    if acc.balance - selling < U.min_balance(header, acc):
                        return (f"account balance {acc.balance} below "
                                f"reserve + selling liabilities {selling}")
                    if U.INT64_MAX - acc.balance < buying:
                        return "account buying liabilities overflow"
            elif d.type == LE.TRUSTLINE:
                tl = d.value
                if tl.asset.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
                    continue
                buying, selling = U.trustline_liabilities(tl)
                if not U.is_authorized_to_maintain_liabilities(tl):
                    if buying or selling:
                        return ("unauthorized trustline holds "
                                "liabilities")
                    continue
                old_b, old_s = (
                    U.trustline_liabilities(old.data.value)
                    if old is not None else (0, 0))
                went_down = old is not None and (
                    tl.balance < old.data.value.balance
                    or tl.limit < old.data.value.limit)
                if went_down or buying > old_b or selling > old_s:
                    if selling > tl.balance:
                        return (f"trustline selling liabilities {selling} "
                                f"exceed balance {tl.balance}")
                    if buying > tl.limit - tl.balance:
                        return (f"trustline buying liabilities {buying} "
                                f"exceed limit headroom")

        for (aid, asset), (b, s) in delta.items():
            if b != 0 or s != 0:
                return (f"offer liabilities out of sync for account "
                        f"{aid[:4].hex()}: buying delta {b}, selling "
                        f"delta {s}")
        return ""


def _account_kb(account_id: bytes) -> bytes:
    k = T.LedgerKey.make(
        T.LedgerEntryType.ACCOUNT,
        T.LedgerKey.arms[T.LedgerEntryType.ACCOUNT][1].make(
            accountID=T.account_id(account_id)))
    return T.LedgerKey.encode(k)


ALL_INVARIANTS = [LedgerEntryIsValid, ConservationOfLumens,
                  AccountSubEntriesCountIsValid, SponsorshipCountIsValid,
                  ConstantProductInvariant, OrderBookIsNotCrossed,
                  LiabilitiesMatchOffers]


class InvariantManager:
    def __init__(self, patterns: List[str] = ()):
        self.invariants: List[Invariant] = []
        for cls in ALL_INVARIANTS:
            if any(re.fullmatch(p, cls.NAME) for p in patterns):
                self.invariants.append(cls())

    def check_on_tx_apply(self, ltx, frame, ok: bool) -> None:
        """Run every checker against a delta layer.  Called per
        OPERATION from the apply loop (ref checkOnOperationApply,
        TransactionFrame.cpp:1441); the same checkers work on any layer
        since they only inspect the delta vs its parent."""
        for inv in self.invariants:
            msg = inv.check_on_tx_apply(ltx, frame, ok)
            if msg:
                raise InvariantDoesNotHold(f"{inv.NAME}: {msg}")

    def check_on_bucket_apply(self, entries, header) -> None:
        """Structural validity of entries assumed from buckets during
        catchup (ref InvariantManagerImpl::checkOnBucketApply,
        src/invariant/InvariantManagerImpl.h:40-46 +
        BucketListIsConsistentWithDatabase)."""
        if not any(isinstance(i, LedgerEntryIsValid)
                   for i in self.invariants):
            return
        for entry in entries:
            msg = entry_validity_error(entry)
            if msg:
                raise InvariantDoesNotHold(
                    f"LedgerEntryIsValid (bucket apply): {msg}")
