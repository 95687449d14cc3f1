"""Shared transaction/ledger-entry helpers: balances, liabilities, reserves,
thresholds, asset utilities (ref src/transactions/TransactionUtils.cpp).

All arithmetic is exact int64-range Python int; overflow conditions mirror
the reference's checked int64 ops.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..xdr import types as T

INT64_MAX = 2**63 - 1
BASE_RESERVE_STRIDE = 2  # account reserve = (2 + subentries) * baseReserve
MAX_SEQ = INT64_MAX

TX_MAX_OPS = 100
ACCOUNT_SUBENTRY_LIMIT = 1000
MAX_OFFERS_TO_CROSS = 1000
# longest effective path-payment conversion chain: 5 path entries plus
# the send and dest assets = 6 hops (xdr VarArray(Asset, 5) path bound);
# the native kernel hardcodes its twin (MAX_PATH_HOPS, lockstep-pinned)
MAX_PATH_HOPS = 6


# -- thresholds --------------------------------------------------------------

class ThresholdLevel:
    LOW = 0
    MEDIUM = 1
    HIGH = 2


def threshold(account_entry, level: int) -> int:
    th = account_entry.thresholds
    return th[1 + level]


def master_weight(account_entry) -> int:
    return account_entry.thresholds[0]


# -- account extension access ------------------------------------------------

def account_liabilities(acc) -> Tuple[int, int]:
    """(buying, selling)."""
    if acc.ext.type == 1:
        li = acc.ext.value.liabilities
        return li.buying, li.selling
    return 0, 0


def trustline_liabilities(tl) -> Tuple[int, int]:
    if tl.ext.type == 1:
        li = tl.ext.value.liabilities
        return li.buying, li.selling
    return 0, 0


def num_sponsoring(acc) -> int:
    if acc.ext.type == 1 and acc.ext.value.ext.type == 2:
        return acc.ext.value.ext.value.numSponsoring
    return 0


def num_sponsored(acc) -> int:
    if acc.ext.type == 1 and acc.ext.value.ext.type == 2:
        return acc.ext.value.ext.value.numSponsored
    return 0


def seq_time(acc) -> int:
    if (acc.ext.type == 1 and acc.ext.value.ext.type == 2
            and acc.ext.value.ext.value.ext.type == 3):
        return acc.ext.value.ext.value.ext.value.seqTime
    return 0


def seq_ledger(acc) -> int:
    if (acc.ext.type == 1 and acc.ext.value.ext.type == 2
            and acc.ext.value.ext.value.ext.type == 3):
        return acc.ext.value.ext.value.ext.value.seqLedger
    return 0


def _ensure_v3(acc):
    """Return an account value with the V1/V2/V3 extension chain present
    (creating empty levels as needed) so seqLedger/seqTime can be set."""
    if acc.ext.type == 0:
        v1 = T.AccountEntryExtensionV1.make(
            liabilities=T.Liabilities.make(buying=0, selling=0),
            ext=T.AccountEntryExtensionV1.fields[1][1].make(0))
        acc = acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))
    v1 = acc.ext.value
    if v1.ext.type == 0:
        v2 = T.AccountEntryExtensionV2.make(
            numSponsored=0, numSponsoring=0, signerSponsoringIDs=[],
            ext=T.AccountEntryExtensionV2.fields[3][1].make(0))
        v1 = v1._replace(ext=T.AccountEntryExtensionV1.fields[1][1].make(
            2, v2))
        acc = acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))
    v2 = v1.ext.value
    if v2.ext.type == 0:
        v3 = T.AccountEntryExtensionV3.make(
            ext=T.ExtensionPoint.make(0), seqLedger=0, seqTime=0)
        v2 = v2._replace(ext=T.AccountEntryExtensionV2.fields[3][1].make(
            3, v3))
        v1 = v1._replace(ext=T.AccountEntryExtensionV1.fields[1][1].make(
            2, v2))
        acc = acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))
    return acc


def set_seq_info(acc, seq_num: int, ledger_seq: int, close_time: int):
    """Bump seqNum and record seqLedger/seqTime (protocol-19 V3 ext;
    ref TransactionFrame::processSeqNum + updateSeqLedger)."""
    acc = _ensure_v3(acc)
    v1 = acc.ext.value
    v2 = v1.ext.value
    v3 = v2.ext.value._replace(seqLedger=ledger_seq, seqTime=close_time)
    v2 = v2._replace(ext=T.AccountEntryExtensionV2.fields[3][1].make(3, v3))
    v1 = v1._replace(ext=T.AccountEntryExtensionV1.fields[1][1].make(2, v2))
    return acc._replace(
        seqNum=seq_num, ext=T.AccountEntry.fields[9][1].make(1, v1))


def set_trustline_liabilities(tl, buying: int, selling: int):
    """tl with liabilities set (ext v1 created on demand; ref
    prepareTrustLineEntryExtensionV1)."""
    if tl.ext.type == 1:
        v1 = tl.ext.value._replace(
            liabilities=T.Liabilities.make(buying=buying, selling=selling))
    else:
        ext_cls = T.TrustLineEntry.fields[5][1]
        v1 = ext_cls.arms[1][1].make(
            liabilities=T.Liabilities.make(buying=buying, selling=selling),
            ext=ext_cls.arms[1][1].fields[1][1].make(0))
    return tl._replace(ext=T.TrustLineEntry.fields[5][1].make(1, v1))


def set_account_liabilities(acc, buying: int, selling: int):
    acc = _ensure_v3(acc) if acc.ext.type == 0 else acc
    v1 = acc.ext.value._replace(
        liabilities=T.Liabilities.make(buying=buying, selling=selling))
    return acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))


# -- reserves / balances -----------------------------------------------------

def min_balance(header, acc) -> int:
    """(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve
    (ref getMinBalance, protocol >= 14 sponsorship form)."""
    count = (BASE_RESERVE_STRIDE + acc.numSubEntries + num_sponsoring(acc)
             - num_sponsored(acc))
    return count * header.baseReserve


def get_available_balance(header, acc) -> int:
    """Spendable native balance: balance - minBalance - selling liabilities
    (ref getAvailableBalance)."""
    _, selling = account_liabilities(acc)
    return max(0, acc.balance - min_balance(header, acc) - selling)


def get_max_receive(header, acc) -> int:
    """INT64_MAX - balance - buying liabilities (ref getMaxAmountReceive)."""
    buying, _ = account_liabilities(acc)
    return INT64_MAX - acc.balance - buying


def add_balance(acc, delta: int):
    """acc with balance += delta, or None on under/overflow against
    liabilities+reserve-free bounds (ref addBalance for accounts; the
    reserve check is the caller's job)."""
    nb = acc.balance + delta
    if nb < 0 or nb > INT64_MAX:
        return None
    return acc._replace(balance=nb)


def trustline_available_balance(tl) -> int:
    _, selling = trustline_liabilities(tl)
    return max(0, tl.balance - selling)


def trustline_max_receive(tl) -> int:
    buying, _ = trustline_liabilities(tl)
    return tl.limit - tl.balance - buying


# -- assets ------------------------------------------------------------------

def asset_native():
    return T.Asset.make(T.AssetType.ASSET_TYPE_NATIVE)


def asset_alphanum4(code: bytes, issuer: bytes):
    return T.Asset.make(
        T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
        T.AlphaNum4.make(assetCode=code.ljust(4, b"\x00"),
                         issuer=T.account_id(issuer)))


def asset_alphanum12(code: bytes, issuer: bytes):
    return T.Asset.make(
        T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
        T.AlphaNum12.make(assetCode=code.ljust(12, b"\x00"),
                          issuer=T.account_id(issuer)))


def make_asset(code: bytes, issuer: Optional[bytes] = None):
    if issuer is None:
        return asset_native()
    if len(code) <= 4:
        return asset_alphanum4(code, issuer)
    return asset_alphanum12(code, issuer)


def is_native(asset) -> bool:
    return asset.type == T.AssetType.ASSET_TYPE_NATIVE


def asset_issuer(asset) -> Optional[bytes]:
    if asset.type in (T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                      T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM12):
        return asset.value.issuer.value
    return None


def asset_code(asset) -> Optional[bytes]:
    if asset.type in (T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                      T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM12):
        return asset.value.assetCode
    return None


def is_asset_valid(asset) -> bool:
    """Asset code constraints: [a-zA-Z0-9]+ right-zero-padded, 1-4 / 5-12
    chars (ref isAssetValid)."""
    if asset.type == T.AssetType.ASSET_TYPE_NATIVE:
        return True
    code = asset_code(asset)
    if code is None:
        return False
    body = code.rstrip(b"\x00")
    if b"\x00" in body:
        return False
    if not body or not all(
            48 <= c <= 57 or 65 <= c <= 90 or 97 <= c <= 122 for c in body):
        return False
    if asset.type == T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
        return 1 <= len(body) <= 4
    return 5 <= len(body) <= 12


def asset_key(asset) -> bytes:
    return T.Asset.encode(asset)


def assets_equal(a, b) -> bool:
    return T.Asset.encode(a) == T.Asset.encode(b)


def to_trustline_asset(asset):
    """Asset -> TrustLineAsset (same arms for the classic types)."""
    return T.TrustLineAsset.make(asset.type, asset.value)


def trustline_asset_to_asset(tl_asset):
    assert tl_asset.type != T.AssetType.ASSET_TYPE_POOL_SHARE
    return T.Asset.make(tl_asset.type, tl_asset.value)


def muxed_to_account_id(muxed) -> bytes:
    """MuxedAccount -> raw ed25519 key bytes."""
    if muxed.type == T.CryptoKeyType.KEY_TYPE_ED25519:
        return muxed.value
    return muxed.value.ed25519


# -- trustline flags ---------------------------------------------------------

def is_authorized(tl) -> bool:
    return bool(tl.flags & T.AUTHORIZED_FLAG)


def is_authorized_to_maintain_liabilities(tl) -> bool:
    return bool(tl.flags & (T.AUTHORIZED_FLAG
                            | T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG))


def is_clawback_enabled_tl(tl) -> bool:
    return bool(tl.flags & T.TRUSTLINE_CLAWBACK_ENABLED_FLAG)


# -- entry builders ----------------------------------------------------------

def wrap_entry(type_, value, seq: int = 0, sponsor: Optional[bytes] = None):
    if sponsor is None:
        ext = T.LedgerEntry.fields[2][1].make(0)
    else:
        ext = T.LedgerEntry.fields[2][1].make(
            1, T.LedgerEntryExtensionV1.make(
                sponsoringID=T.account_id(sponsor),
                ext=T.LedgerEntryExtensionV1.fields[1][1].make(0)))
    return T.LedgerEntry.make(
        lastModifiedLedgerSeq=seq,
        data=T.LedgerEntryData.make(type_, value),
        ext=ext)


def make_account_entry(account_id: bytes, balance: int, seq_num: int = 0,
                       **kw):
    acc = T.AccountEntry.make(
        accountID=T.account_id(account_id),
        balance=balance,
        seqNum=seq_num,
        numSubEntries=kw.get("numSubEntries", 0),
        inflationDest=kw.get("inflationDest"),
        flags=kw.get("flags", 0),
        homeDomain=kw.get("homeDomain", b""),
        thresholds=kw.get("thresholds", b"\x01\x00\x00\x00"),
        signers=kw.get("signers", []),
        ext=T.AccountEntry.fields[9][1].make(0),
    )
    return wrap_entry(T.LedgerEntryType.ACCOUNT, acc)


def make_trustline_entry(account_id: bytes, asset, balance: int = 0,
                         limit: int = INT64_MAX,
                         flags: int = T.AUTHORIZED_FLAG):
    tl = T.TrustLineEntry.make(
        accountID=T.account_id(account_id),
        asset=to_trustline_asset(asset),
        balance=balance,
        limit=limit,
        flags=flags,
        ext=T.TrustLineEntry.fields[5][1].make(0),
    )
    return wrap_entry(T.LedgerEntryType.TRUSTLINE, tl)
