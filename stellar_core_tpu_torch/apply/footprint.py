"""Declared per-transaction footprints for parallel apply.

A footprint is the set of canonical LedgerKey byte strings a
transaction may READ or WRITE during apply, plus three structured
conflict tokens the key space cannot express:

- order-book pairs (``book_pairs``): DEX ops touch arbitrary resting
  offers of an asset pair; the pair itself is the conflict unit and the
  planner materializes every resting offer (and its seller's entries)
  into concrete keys at plan time;
- offer-id allocation (``allocates_offer_ids``): creating a resting
  offer consumes ``header.idPool`` — a global counter whose values are
  consensus-visible, so all allocating txs serialize into one cluster.

Ops whose access pattern cannot be declared (trustline-flag revocation
pulling offers and redeeming pool shares by prefix scan) mark the
footprint ``precise = False``; the planner then refuses to parallelize
the whole set — the always-correct sequential path applies it.

Everything here runs on the MAIN thread at plan time, against the open
close ``LedgerTxn`` (post-fee state), so SQL access and root caches
need no locking.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

from ..ledger.ledger_txn import (
    LedgerTxnRoot, account_key_bytes, key_bytes, trustline_key,
)
from ..xdr import types as T

OT = T.OperationType

#: op types served by a dedicated handler below; anything else is
#: imprecise by default (NotSupported placeholders write nothing, but
#: new op types must OPT IN to parallel apply by declaring a handler)
_IMPRECISE = "imprecise"


class TxFootprint:
    """Declared footprint of one transaction frame."""

    __slots__ = ("index", "reads", "writes", "book_pairs",
                 "allocates_offer_ids", "precise", "reason",
                 "kernel_shape")

    def __init__(self, index: int):
        self.index = index
        self.reads: Set[bytes] = set()
        self.writes: Set[bytes] = set()
        # unordered pairs of canonical XDR Asset encodings
        self.book_pairs: Set[Tuple[bytes, bytes]] = set()
        self.allocates_offer_ids = False
        self.precise = True
        self.reason = ""
        # native-apply eligibility: the structural (state-free) kernel
        # shape of the frame, or None — a pure function of the tx, so
        # nomination-time preplans carry it too (apply/native_apply.py)
        self.kernel_shape: Optional[tuple] = None

    def all_keys(self) -> Set[bytes]:
        return self.reads | self.writes

    def mark_imprecise(self, reason: str) -> None:
        self.precise = False
        self.reason = reason


def pair_token(asset_a: bytes, asset_b: bytes) -> Tuple[bytes, bytes]:
    """Canonical unordered book-pair token over encoded assets."""
    return (asset_a, asset_b) if asset_a <= asset_b else (asset_b, asset_a)


class BookMaterialization:
    """Plan-time expansion of one order-book pair: every resting offer
    in both directions, ready to serve a cluster's ``best_offer`` scans
    without touching SQL from worker threads."""

    __slots__ = ("pair", "offers", "keys", "read_keys", "assets")

    def __init__(self, pair: Tuple[bytes, bytes]):
        self.pair = pair
        # direction (selling, buying) -> sorted [(Fraction, offerID, kb)]
        self.offers: Dict[Tuple[bytes, bytes], List[tuple]] = {}
        self.keys: Set[bytes] = set()       # write keys (offers, sellers…)
        self.read_keys: Set[bytes] = set()  # issuer accounts
        self.assets: List[object] = []      # the two decoded Asset values


class PlanContext:
    """Shared memoization across one close's footprint pass."""

    def __init__(self, ltx):
        self.ltx = ltx
        self.books: Dict[Tuple[bytes, bytes], BookMaterialization] = {}

    # -- order-book expansion ---------------------------------------------

    def book(self, selling, buying) -> BookMaterialization:
        """Materialize (once) the order book for the unordered pair of
        Asset values ``selling``/``buying``."""
        from ..transactions import liquidity_pool as LP
        from ..transactions import utils as U

        sb = T.Asset.encode(selling)
        bb = T.Asset.encode(buying)
        pair = pair_token(sb, bb)
        mat = self.books.get(pair)
        if mat is not None:
            return mat
        mat = BookMaterialization(pair)
        mat.assets = [selling, buying]
        overrides, root = self.ltx._collect_offer_overrides()
        for direction in ((sb, bb), (bb, sb)):
            rows: List[tuple] = []
            if isinstance(root, LedgerTxnRoot):
                for kb, entry in root._offers_by_pair(*direction):
                    if kb in overrides:
                        continue
                    o = entry.data.value
                    rows.append((Fraction(o.price.n, o.price.d),
                                 o.offerID, kb))
                    self._declare_offer(mat, entry)
            for kb, entry in sorted(overrides.items()):
                if entry is None:
                    continue
                o = entry.data.value
                if (T.Asset.encode(o.selling),
                        T.Asset.encode(o.buying)) != direction:
                    continue
                rows.append((Fraction(o.price.n, o.price.d), o.offerID, kb))
                self._declare_offer(mat, entry)
            rows.sort()
            mat.offers[direction] = rows
        # the pair's liquidity pool (path payments quote it on each hop;
        # the native kernel probes the same key for its decline-if-live
        # pool guard — pair_pool_key_bytes is the one derivation)
        mat.keys.add(LP.pair_pool_key_bytes(selling, buying))
        # issuer accounts: crossing checks their existence
        for asset in (selling, buying):
            issuer = None if U.is_native(asset) else U.asset_issuer(asset)
            if issuer is not None:
                mat.read_keys.add(account_key_bytes(issuer))
        self.books[pair] = mat
        return mat

    def _declare_offer(self, mat: BookMaterialization, entry) -> None:
        """One resting offer's full reach: the offer itself, its
        seller's account and trustlines for both legs (crossing settles
        balances on the seller side), and the offer's sponsor (erasing
        a consumed offer credits the sponsor's numSponsoring)."""
        from ..ledger.ledger_txn import entry_to_key
        from ..transactions import sponsorship as SP
        from ..transactions import utils as U

        o = entry.data.value
        seller = o.sellerID.value
        mat.keys.add(key_bytes(entry_to_key(entry)))
        mat.keys.add(account_key_bytes(seller))
        for asset in (o.selling, o.buying):
            if not U.is_native(asset):
                mat.keys.add(key_bytes(trustline_key(
                    seller, U.to_trustline_asset(asset))))
        sponsor = SP.entry_sponsor(entry)
        if sponsor is not None:
            mat.keys.add(account_key_bytes(sponsor))


def _tl_kb(account_id: bytes, asset) -> Optional[bytes]:
    from ..transactions import utils as U

    if U.is_native(asset):
        return None
    return key_bytes(trustline_key(account_id, U.to_trustline_asset(asset)))


def _issuer_kb(asset) -> Optional[bytes]:
    from ..transactions import utils as U

    issuer = None if U.is_native(asset) else U.asset_issuer(asset)
    return None if issuer is None else account_key_bytes(issuer)


def _cb_kb(balance_id: bytes) -> bytes:
    LE = T.LedgerEntryType
    return key_bytes(T.LedgerKey.make(
        LE.CLAIMABLE_BALANCE,
        T.LedgerKey.arms[LE.CLAIMABLE_BALANCE][1].make(
            balanceID=balance_id)))


def _offer_kb(seller_id: bytes, offer_id: int) -> bytes:
    LE = T.LedgerEntryType
    return key_bytes(T.LedgerKey.make(
        LE.OFFER, T.LedgerKey.arms[LE.OFFER][1].make(
            sellerID=T.account_id(seller_id), offerID=offer_id)))


def _data_kb(account_id: bytes, name) -> bytes:
    LE = T.LedgerEntryType
    return key_bytes(T.LedgerKey.make(
        LE.DATA, T.LedgerKey.arms[LE.DATA][1].make(
            accountID=T.account_id(account_id), dataName=name)))


# -- per-op handlers ----------------------------------------------------------
# Each handler(fp, opf, ctx) adds the op's declared keys to the
# footprint.  The table is module-level on purpose: tests monkeypatch
# entries to force under-declared footprints (the escape-abort path).

def _fp_create_account(fp, opf, ctx):
    fp.writes.add(account_key_bytes(opf.body.destination.value))


def _fp_payment(fp, opf, ctx):
    from ..transactions import utils as U

    b = opf.body
    dest = U.muxed_to_account_id(b.destination)
    src = opf.source_account_id()
    fp.writes.add(account_key_bytes(dest))
    for aid in (src, dest):
        kb = _tl_kb(aid, b.asset)
        if kb is not None:
            fp.writes.add(kb)


def _fp_account_merge(fp, opf, ctx):
    from ..transactions import utils as U

    fp.writes.add(account_key_bytes(U.muxed_to_account_id(opf.body)))


def _fp_change_trust(fp, opf, ctx):
    from ..transactions import liquidity_pool as LP

    line = opf.body.line
    src = opf.source_account_id()
    if line.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
        params = line.value
        pool_id = LP.pool_id_from_params(params)
        fp.writes.add(key_bytes(LP.pool_share_trustline_key(src, pool_id)))
        fp.writes.add(key_bytes(LP.pool_key(pool_id)))
        cp = params.value
        for a in (cp.assetA, cp.assetB):
            kb = _tl_kb(src, a)
            if kb is not None:
                fp.writes.add(kb)
            ik = _issuer_kb(a)
            if ik is not None:
                fp.reads.add(ik)
        return
    asset = T.Asset.make(line.type, line.value)
    kb = _tl_kb(src, asset)
    if kb is not None:
        fp.writes.add(kb)
    ik = _issuer_kb(asset)
    if ik is not None:
        fp.reads.add(ik)


def _fp_manage_offer(fp, opf, ctx):
    src = opf.source_account_id()
    selling, buying, amount, _price, offer_id = opf._params()
    for asset in (selling, buying):
        kb = _tl_kb(src, asset)
        if kb is not None:
            fp.writes.add(kb)
        ik = _issuer_kb(asset)
        if ik is not None:
            fp.reads.add(ik)
    if offer_id:
        fp.writes.add(_offer_kb(src, offer_id))
        # modify/delete releases the LOADED offer's liabilities, whose
        # assets may differ from the op's declared pair: without the
        # resting offer's own trustline reach the release is an
        # undeclared write (worker escape / kernel decline) every time
        existing = ctx.ltx.get(_offer_kb(src, offer_id))
        if existing is not None:
            o = existing.data.value
            for asset in (o.selling, o.buying):
                kb = _tl_kb(src, asset)
                if kb is not None:
                    fp.writes.add(kb)
    if amount != 0:
        # the pair's materialized reach (resting offers, sellers,
        # trustlines, pool, sponsors) is attached ONCE per pair by the
        # planner — not unioned into every DEX tx's own key set, which
        # would make sponsor expansion O(txs x book)
        mat = ctx.book(selling, buying)
        fp.book_pairs.add(mat.pair)
        if offer_id == 0:
            fp.allocates_offer_ids = True


def _fp_path_payment(fp, opf, ctx):
    from ..transactions import utils as U

    b = opf.body
    src = opf.source_account_id()
    dest = U.muxed_to_account_id(b.destination)
    fp.writes.add(account_key_bytes(dest))
    chain = [b.sendAsset, *b.path, b.destAsset]
    for kb in (_tl_kb(src, b.sendAsset), _tl_kb(dest, b.destAsset)):
        if kb is not None:
            fp.writes.add(kb)
    for asset in chain:
        ik = _issuer_kb(asset)
        if ik is not None:
            fp.reads.add(ik)
    for i in range(len(chain) - 1):
        if U.assets_equal(chain[i], chain[i + 1]):
            continue
        mat = ctx.book(chain[i], chain[i + 1])
        fp.book_pairs.add(mat.pair)


def _fp_source_only(fp, opf, ctx):
    pass  # tx/op source accounts are declared for every tx


def _fp_manage_data(fp, opf, ctx):
    fp.writes.add(_data_kb(opf.source_account_id(), opf.body.dataName))


def _fp_clawback(fp, opf, ctx):
    from ..transactions import utils as U

    b = opf.body
    kb = _tl_kb(U.muxed_to_account_id(b.from_), b.asset)
    if kb is not None:
        fp.writes.add(kb)
    fp.writes.add(account_key_bytes(U.muxed_to_account_id(b.from_)))


def _fp_create_cb(fp, opf, ctx):
    b = opf.body
    fp.writes.add(_cb_kb(opf.balance_id()))
    src = opf.source_account_id()
    kb = _tl_kb(src, b.asset)
    if kb is not None:
        fp.writes.add(kb)
    ik = _issuer_kb(b.asset)
    if ik is not None:
        fp.reads.add(ik)
    for cl in b.claimants:
        fp.reads.add(account_key_bytes(cl.value.destination.value))


def _fp_claim_cb(fp, opf, ctx):
    fp.writes.add(_cb_kb(opf.body.balanceID))
    src = opf.source_account_id()
    entry = ctx.ltx.get(_cb_kb(opf.body.balanceID))
    if entry is not None:
        asset = entry.data.value.asset
        kb = _tl_kb(src, asset)
        if kb is not None:
            fp.writes.add(kb)
        ik = _issuer_kb(asset)
        if ik is not None:
            fp.reads.add(ik)


def _fp_clawback_cb(fp, opf, ctx):
    fp.writes.add(_cb_kb(opf.body.balanceID))


def _fp_begin_sponsoring(fp, opf, ctx):
    fp.reads.add(account_key_bytes(opf.body.sponsoredID.value))


def _fp_revoke_sponsorship(fp, opf, ctx):
    b = opf.body
    RS = T.RevokeSponsorshipType
    if b.type == RS.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
        lk = b.value
        fp.writes.add(key_bytes(lk))
        # the owner account's counts move with the sponsorship
        owner = getattr(lk.value, "accountID", None) or \
            getattr(lk.value, "sellerID", None)
        if owner is not None:
            fp.writes.add(account_key_bytes(owner.value))
    else:
        fp.writes.add(account_key_bytes(b.value.accountID.value))


def _fp_pool_op(fp, opf, ctx):
    from ..transactions import liquidity_pool as LP

    b = opf.body
    pool_id = b.liquidityPoolID
    src = opf.source_account_id()
    fp.writes.add(key_bytes(LP.pool_key(pool_id)))
    fp.writes.add(key_bytes(LP.pool_share_trustline_key(src, pool_id)))
    pool = ctx.ltx.get(key_bytes(LP.pool_key(pool_id)))
    if pool is not None:
        cp = pool.data.value.body.value
        for a in (cp.params.assetA, cp.params.assetB):
            kb = _tl_kb(src, a)
            if kb is not None:
                fp.writes.add(kb)
            ik = _issuer_kb(a)
            if ik is not None:
                fp.reads.add(ik)


def _fp_imprecise(reason: str):
    def handler(fp, opf, ctx):
        fp.mark_imprecise(reason)
    return handler


#: OperationType -> handler.  Module-level and mutable BY DESIGN: the
#: adversarial escape tests patch entries to under-declare footprints.
OP_FOOTPRINTS = {
    OT.CREATE_ACCOUNT: _fp_create_account,
    OT.PAYMENT: _fp_payment,
    OT.ACCOUNT_MERGE: _fp_account_merge,
    OT.CHANGE_TRUST: _fp_change_trust,
    OT.MANAGE_SELL_OFFER: _fp_manage_offer,
    OT.MANAGE_BUY_OFFER: _fp_manage_offer,
    OT.CREATE_PASSIVE_SELL_OFFER: _fp_manage_offer,
    OT.PATH_PAYMENT_STRICT_RECEIVE: _fp_path_payment,
    OT.PATH_PAYMENT_STRICT_SEND: _fp_path_payment,
    OT.SET_OPTIONS: _fp_source_only,
    OT.BUMP_SEQUENCE: _fp_source_only,
    OT.INFLATION: _fp_source_only,
    OT.MANAGE_DATA: _fp_manage_data,
    OT.CLAWBACK: _fp_clawback,
    OT.CREATE_CLAIMABLE_BALANCE: _fp_create_cb,
    OT.CLAIM_CLAIMABLE_BALANCE: _fp_claim_cb,
    OT.CLAWBACK_CLAIMABLE_BALANCE: _fp_clawback_cb,
    OT.BEGIN_SPONSORING_FUTURE_RESERVES: _fp_begin_sponsoring,
    OT.END_SPONSORING_FUTURE_RESERVES: _fp_source_only,
    OT.REVOKE_SPONSORSHIP: _fp_revoke_sponsorship,
    OT.LIQUIDITY_POOL_DEPOSIT: _fp_pool_op,
    OT.LIQUIDITY_POOL_WITHDRAW: _fp_pool_op,
    # trustline-flag revocation pulls the trustor's whole offer list and
    # prefix-scans pool-share trustlines — undeclarable; sequential only
    OT.ALLOW_TRUST: _fp_imprecise("allow_trust offer pull"),
    OT.SET_TRUST_LINE_FLAGS: _fp_imprecise("set_trust_line_flags pull"),
}


def footprint_for(index: int, frame, ctx: PlanContext) -> TxFootprint:
    """Full declared footprint of one frame (fee-bump aware)."""
    from .native_apply import frame_kernel_shape

    fp = TxFootprint(index)
    fp.kernel_shape = frame_kernel_shape(frame)
    fp.writes.add(account_key_bytes(frame.source_account_id()))
    fee_src = getattr(frame, "fee_source_id", None)
    if fee_src is not None:
        fp.writes.add(account_key_bytes(fee_src()))
    for opf in frame.op_frames:
        fp.writes.add(account_key_bytes(opf.source_account_id()))
        handler = OP_FOOTPRINTS.get(opf.op.body.type)
        if handler is None:
            fp.mark_imprecise(f"no handler for op type {opf.op.body.type}")
            return fp
        try:
            handler(fp, opf, ctx)
        except Exception as e:  # malformed body: let sequential apply fail it
            fp.mark_imprecise(f"footprint error: {e!r}")
            return fp
        if not fp.precise:
            return fp
    _expand_sponsors(fp, ctx)
    return fp


def _expand_sponsors(fp: TxFootprint, ctx: PlanContext) -> None:
    """Removing or resizing a sponsored entry credits its sponsor's
    ``numSponsoring`` — an undeclared account write unless expanded
    here.  One round suffices: sponsors are accounts, and touching a
    sponsor's counters never cascades further."""
    from ..transactions import sponsorship as SP

    extra: Set[bytes] = set()
    for kb in sorted(fp.all_keys()):
        entry = ctx.ltx.get(kb)
        if entry is None or kb.startswith(b"\xff"):
            continue
        sponsor = SP.entry_sponsor(entry)
        if sponsor is not None:
            extra.add(account_key_bytes(sponsor))
        if entry.data.type == T.LedgerEntryType.ACCOUNT:
            for sid in SP.signer_sponsoring_ids(entry.data.value):
                if sid is not None:
                    extra.add(account_key_bytes(sid.value))
    fp.writes |= extra
