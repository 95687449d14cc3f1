"""Reserve-sponsorship accounting (ref src/transactions/SponsorshipUtils.cpp,
903 LoC) plus the per-tx active-sponsorship map.

Semantics re-derived from the reference:

- An *active sponsorship* (created by BEGIN_SPONSORING_FUTURE_RESERVES and
  closed by END_SPONSORING_FUTURE_RESERVES) is a (sponsoredID -> sponsoringID)
  binding that lives only inside LedgerTxn layers as a virtual entry
  (ref InternalLedgerEntry SPONSORSHIP, src/ledger/InternalLedgerEntry.h:16)
  so it rolls back with its op/tx.  A parallel SPONSORSHIP_COUNTER per
  sponsoring account detects recursion.
- When an account with an active sponsorship creates a ledger entry (or
  signer), the *sponsor* pays the reserve: sponsor.numSponsoring += mult,
  owner.numSponsored += mult, and the entry records sponsoringID
  (ref SponsorshipUtils.cpp:364 establishEntrySponsorship).
- mult = reserve multiplier (ref computeMultiplier :190): ACCOUNT 2,
  TRUSTLINE 1 (2 for pool shares), OFFER/DATA 1, CLAIMABLE_BALANCE
  #claimants.
- Claimable balances are *always* sponsored (by the creator if no active
  sponsorship); they are not subentries of any account.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..ledger.ledger_txn import (
    entry_to_key, sponsorship_counter_key, sponsorship_key,
)
from ..xdr import types as T
from . import utils as U

UINT32_MAX = 2**32 - 1


class SponsorshipError(Exception):
    """Invalid internal state — fail-stop, like the reference's throws."""


class SponsorshipResult:
    SUCCESS = 0
    LOW_RESERVE = 1
    TOO_MANY_SUBENTRIES = 2
    TOO_MANY_SPONSORING = 3
    TOO_MANY_SPONSORED = 4


def map_sponsorship_result(res: int, low_reserve_result):
    """Shared SponsorshipResult -> OperationResult mapping for create-side
    callers (ref the per-op switch over createEntryWithPossibleSponsorship
    results): LOW_RESERVE maps to the op-specific result, the TOO_MANY_*
    overflows to top-level op codes, anything else is an invalid-state
    fail-stop.  Returns None on SUCCESS."""
    from ..xdr import types as T

    if res == SponsorshipResult.SUCCESS:
        return None
    if res == SponsorshipResult.LOW_RESERVE:
        return low_reserve_result
    if res == SponsorshipResult.TOO_MANY_SUBENTRIES:
        return T.OperationResult.make(
            T.OperationResultCode.opTOO_MANY_SUBENTRIES)
    if res == SponsorshipResult.TOO_MANY_SPONSORING:
        return T.OperationResult.make(
            T.OperationResultCode.opTOO_MANY_SPONSORING)
    # TOO_MANY_SPONSORED is unreachable through valid operations (every
    # sponsored-count increment is bounded by ACCOUNT_SUBENTRY_LIMIT or
    # MAX_SIGNERS, both << UINT32_MAX); the reference likewise falls
    # through and throws (ref RevokeSponsorshipOpFrame.cpp:66-70)
    raise SponsorshipError(f"unexpected sponsorship result {res}")


# -- active-sponsorship map (virtual entries) --------------------------------

def load_sponsorship(ltx, sponsored_id: bytes) -> Optional[bytes]:
    """Sponsoring account id for an active sponsorship of sponsored_id."""
    return ltx.get(sponsorship_key(sponsored_id))


def load_sponsorship_counter(ltx, sponsoring_id: bytes) -> int:
    v = ltx.get(sponsorship_counter_key(sponsoring_id))
    return v if v is not None else 0


def any_active_sponsorships(ltx) -> bool:
    """True if any sponsorship is still open (txBAD_SPONSORSHIP check at the
    end of applyOperations, ref TransactionFrame.cpp)."""
    return bool(ltx.live_virtual_keys(b"\xffSP"))


# -- account extension count updates -----------------------------------------

def _ensure_v2(acc):
    """Account value with the V1/V2 extension chain (not V3 — matches what
    the reference's prepareAccountEntryExtensionV2 creates)."""
    if acc.ext.type == 0:
        v1 = T.AccountEntryExtensionV1.make(
            liabilities=T.Liabilities.make(buying=0, selling=0),
            ext=T.AccountEntryExtensionV1.fields[1][1].make(0))
        acc = acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))
    v1 = acc.ext.value
    if v1.ext.type == 0:
        v2 = T.AccountEntryExtensionV2.make(
            numSponsored=0, numSponsoring=0,
            signerSponsoringIDs=[None] * len(acc.signers),
            ext=T.AccountEntryExtensionV2.fields[3][1].make(0))
        v1 = v1._replace(
            ext=T.AccountEntryExtensionV1.fields[1][1].make(2, v2))
        acc = acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))
    return acc


def _update_v2(acc, **changes):
    acc = _ensure_v2(acc)
    v1 = acc.ext.value
    v2 = v1.ext.value._replace(**changes)
    v1 = v1._replace(ext=T.AccountEntryExtensionV1.fields[1][1].make(2, v2))
    return acc._replace(ext=T.AccountEntry.fields[9][1].make(1, v1))


def add_num_sponsoring(acc, delta: int):
    n = U.num_sponsoring(acc) + delta
    if n < 0:
        raise SponsorshipError("numSponsoring underflow")
    return _update_v2(acc, numSponsoring=n)


def add_num_sponsored(acc, delta: int):
    n = U.num_sponsored(acc) + delta
    if n < 0:
        raise SponsorshipError("numSponsored underflow")
    return _update_v2(acc, numSponsored=n)


def signer_sponsoring_ids(acc) -> list:
    """Parallel array to acc.signers; None entries = unsponsored."""
    if acc.ext.type == 1 and acc.ext.value.ext.type == 2:
        ids = list(acc.ext.value.ext.value.signerSponsoringIDs)
        # tolerate length drift from pre-v2 signer edits
        while len(ids) < len(acc.signers):
            ids.append(None)
        return ids[:len(acc.signers)]
    return [None] * len(acc.signers)


def set_signer_sponsoring_ids(acc, ids: list):
    return _update_v2(acc, signerSponsoringIDs=list(ids))


# -- multipliers / classification --------------------------------------------

def compute_multiplier(entry) -> int:
    """ref computeMultiplier (SponsorshipUtils.cpp:190)."""
    t = entry.data.type
    LE = T.LedgerEntryType
    if t == LE.ACCOUNT:
        return 2
    if t == LE.TRUSTLINE:
        if entry.data.value.asset.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
            return 2
        return 1
    if t in (LE.OFFER, LE.DATA):
        return 1
    if t == LE.CLAIMABLE_BALANCE:
        return len(entry.data.value.claimants)
    raise SponsorshipError(f"invalid entry type for sponsorship: {t}")


def is_subentry(entry) -> bool:
    return entry.data.type in (T.LedgerEntryType.TRUSTLINE,
                               T.LedgerEntryType.OFFER,
                               T.LedgerEntryType.DATA)


def entry_sponsor(entry) -> Optional[bytes]:
    """The recorded sponsor of a ledger entry, if any."""
    if entry.ext.type == 1 and entry.ext.value.sponsoringID is not None:
        return entry.ext.value.sponsoringID.value
    return None


def set_entry_sponsor(entry, sponsor_id: Optional[bytes]):
    if sponsor_id is None:
        return entry._replace(ext=T.LedgerEntry.fields[2][1].make(0))
    return entry._replace(ext=T.LedgerEntry.fields[2][1].make(
        1, T.LedgerEntryExtensionV1.make(
            sponsoringID=T.account_id(sponsor_id),
            ext=T.LedgerEntryExtensionV1.fields[1][1].make(0))))


# -- establish / remove checks (ref :56-130) ---------------------------------

def _too_many_sponsoring(acc, mult: int) -> bool:
    return U.num_sponsoring(acc) > UINT32_MAX - mult


def _can_establish(header, sponsoring_acc, sponsored_acc, mult: int) -> int:
    reserve = mult * header.baseReserve
    if U.get_available_balance(header, sponsoring_acc) < reserve:
        return SponsorshipResult.LOW_RESERVE
    if _too_many_sponsoring(sponsoring_acc, mult):
        return SponsorshipResult.TOO_MANY_SPONSORING
    if sponsored_acc is not None and \
            U.num_sponsored(sponsored_acc) > UINT32_MAX - mult:
        return SponsorshipResult.TOO_MANY_SPONSORED
    return SponsorshipResult.SUCCESS


def _can_remove(header, sponsoring_acc, sponsored_acc, mult: int) -> int:
    if U.num_sponsoring(sponsoring_acc) < mult:
        raise SponsorshipError("insufficient numSponsoring")
    if sponsored_acc is not None and U.num_sponsored(sponsored_acc) < mult:
        raise SponsorshipError("insufficient numSponsored")
    reserve = mult * header.baseReserve
    if sponsored_acc is not None and \
            U.get_available_balance(header, sponsored_acc) < reserve:
        return SponsorshipResult.LOW_RESERVE
    return SponsorshipResult.SUCCESS


def _too_many_subentries(acc, mult: int) -> bool:
    return acc.numSubEntries + mult > U.ACCOUNT_SUBENTRY_LIMIT


# -- the main create/remove entry points -------------------------------------
# These combine the reference's canCreate*/create* pairs into one helper that
# checks, mutates the owner/sponsor accounts through the ltx, and returns the
# (possibly sponsor-stamped) entry.

def create_entry_with_possible_sponsorship(
        ltx, entry, owner_id: bytes,
        owner_entry=None) -> Tuple[int, object]:
    """Create-side reserve accounting for a new ledger entry owned (or, for
    claimable balances, created) by owner_id.

    Returns (SponsorshipResult, entry') where entry' carries the sponsor
    stamp.  On SUCCESS the owner's numSubEntries / counts and the sponsor's
    counts have been written through ``ltx``; the caller puts entry' itself.
    Claimable balances are always sponsored — by the active sponsor if any,
    else by owner_id (ref CreateClaimableBalanceOpFrame::doApply).
    """
    header = ltx.header()
    mult = compute_multiplier(entry)
    is_cb = entry.data.type == T.LedgerEntryType.CLAIMABLE_BALANCE
    if owner_entry is None:
        owner_entry = ltx.load_account(owner_id)
    if owner_entry is None:
        raise SponsorshipError("owner account missing")
    owner = owner_entry.data.value

    sponsor_id = load_sponsorship(ltx, owner_id)
    if sponsor_id is None and is_cb:
        sponsor_id = owner_id

    if sponsor_id is None:
        # unsponsored: owner pays the reserve (ref :473)
        if entry.data.type != T.LedgerEntryType.ACCOUNT:
            if _too_many_subentries(owner, mult):
                return SponsorshipResult.TOO_MANY_SUBENTRIES, entry
            reserve = mult * header.baseReserve
            if U.get_available_balance(header, owner) < reserve:
                return SponsorshipResult.LOW_RESERVE, entry
            owner = owner._replace(numSubEntries=owner.numSubEntries + mult)
            _put_account(ltx, owner_entry, owner)
        else:
            if entry.data.value.balance < U.min_balance(
                    header, owner):
                return SponsorshipResult.LOW_RESERVE, entry
        return SponsorshipResult.SUCCESS, entry

    # sponsored create (ref :517)
    if sponsor_id == owner_id and is_cb:
        sponsoring_entry = owner_entry
    else:
        sponsoring_entry = ltx.load_account(sponsor_id)
        if sponsoring_entry is None:
            raise SponsorshipError("sponsoring account missing")
    sponsoring = sponsoring_entry.data.value

    sponsored_acc = None
    if entry.data.type == T.LedgerEntryType.ACCOUNT:
        sponsored_acc = entry.data.value
    elif is_subentry(entry):
        sponsored_acc = owner
        if _too_many_subentries(owner, mult):
            return SponsorshipResult.TOO_MANY_SUBENTRIES, entry

    res = _can_establish(header, sponsoring, sponsored_acc, mult)
    if res != SponsorshipResult.SUCCESS:
        return res, entry

    sponsoring = add_num_sponsoring(sponsoring, mult)
    _put_account(ltx, sponsoring_entry, sponsoring)
    if entry.data.type == T.LedgerEntryType.ACCOUNT:
        entry = entry._replace(data=T.LedgerEntryData.make(
            T.LedgerEntryType.ACCOUNT,
            add_num_sponsored(entry.data.value, mult)))
    elif is_subentry(entry):
        owner = add_num_sponsored(owner, mult)
        owner = owner._replace(numSubEntries=owner.numSubEntries + mult)
        _put_account(ltx, owner_entry, owner)
    entry = set_entry_sponsor(entry, sponsor_id)
    return SponsorshipResult.SUCCESS, entry


def remove_entry_with_possible_sponsorship(
        ltx, entry, owner_id: Optional[bytes]) -> None:
    """Remove-side reserve accounting: release the sponsor's numSponsoring
    (and owner's numSponsored / numSubEntries).  The caller erases the entry
    itself.  owner_id is None for claimable balances."""
    mult = compute_multiplier(entry)
    sponsor_id = entry_sponsor(entry)

    owner_entry = None
    owner = None
    if owner_id is not None:
        owner_entry = ltx.load_account(owner_id)
        if owner_entry is None:
            raise SponsorshipError("owner account missing on remove")
        owner = owner_entry.data.value

    if sponsor_id is not None:
        sponsoring_entry = ltx.load_account(sponsor_id)
        if sponsoring_entry is not None:
            sponsoring = sponsoring_entry.data.value
            if U.num_sponsoring(sponsoring) < mult:
                raise SponsorshipError("invalid sponsoring account state")
            sponsoring = add_num_sponsoring(sponsoring, -mult)
            _put_account(ltx, sponsoring_entry, sponsoring)
        if owner is not None and is_subentry(entry):
            if U.num_sponsored(owner) < mult:
                raise SponsorshipError("invalid sponsored account state")
            owner = add_num_sponsored(owner, -mult)

    if owner is not None and is_subentry(entry):
        if owner.numSubEntries < mult:
            raise SponsorshipError("invalid account state")
        owner = owner._replace(numSubEntries=owner.numSubEntries - mult)
        _put_account(ltx, owner_entry, owner)


# -- revoke-time sponsorship moves (entry survives; only the reserve payer
# changes — ref establish/remove/transferEntrySponsorship :364-414) ----------

def establish_entry_sponsorship(ltx, entry, sponsoring_id: bytes,
                                owner_id: Optional[bytes]):
    """Sponsor an existing unsponsored entry.  Returns (res, entry')."""
    if entry_sponsor(entry) is not None:
        raise SponsorshipError("sponsoring sponsored entry")
    header = ltx.header()
    mult = compute_multiplier(entry)
    sponsoring_entry = ltx.load_account(sponsoring_id)
    sponsoring = sponsoring_entry.data.value

    if entry.data.type == T.LedgerEntryType.ACCOUNT:
        res = _can_establish(header, sponsoring, entry.data.value, mult)
        if res != SponsorshipResult.SUCCESS:
            return res, entry
        entry = entry._replace(data=T.LedgerEntryData.make(
            T.LedgerEntryType.ACCOUNT,
            add_num_sponsored(entry.data.value, mult)))
    else:
        owner_entry = ltx.load_account(owner_id) if owner_id else None
        owner = owner_entry.data.value if owner_entry else None
        res = _can_establish(header, sponsoring, owner, mult)
        if res != SponsorshipResult.SUCCESS:
            return res, entry
        if owner_entry is not None and is_subentry(entry):
            _put_account(ltx, owner_entry, add_num_sponsored(owner, mult))
    _put_account(ltx, sponsoring_entry, add_num_sponsoring(sponsoring, mult))
    return SponsorshipResult.SUCCESS, set_entry_sponsor(entry, sponsoring_id)


def remove_entry_sponsorship(ltx, entry, owner_id: Optional[bytes]):
    """Un-sponsor an entry: the owner takes the reserve back.  Returns
    (res, entry')."""
    sponsor_id = entry_sponsor(entry)
    if sponsor_id is None:
        raise SponsorshipError("removing sponsorship from unsponsored entry")
    header = ltx.header()
    mult = compute_multiplier(entry)
    sponsoring_entry = ltx.load_account(sponsor_id)
    sponsoring = sponsoring_entry.data.value

    if entry.data.type == T.LedgerEntryType.ACCOUNT:
        res = _can_remove(header, sponsoring, entry.data.value, mult)
        if res != SponsorshipResult.SUCCESS:
            return res, entry
        entry = entry._replace(data=T.LedgerEntryData.make(
            T.LedgerEntryType.ACCOUNT,
            add_num_sponsored(entry.data.value, -mult)))
    else:
        owner_entry = ltx.load_account(owner_id) if owner_id else None
        owner = owner_entry.data.value if owner_entry else None
        res = _can_remove(header, sponsoring, owner, mult)
        if res != SponsorshipResult.SUCCESS:
            return res, entry
        if owner_entry is not None and is_subentry(entry):
            _put_account(ltx, owner_entry, add_num_sponsored(owner, -mult))
    _put_account(ltx, sponsoring_entry,
                 add_num_sponsoring(sponsoring, -mult))
    return SponsorshipResult.SUCCESS, set_entry_sponsor(entry, None)


def transfer_entry_sponsorship(ltx, entry, new_sponsor_id: bytes):
    """Move sponsorship old->new sponsor.  Returns (res, entry')."""
    old_sponsor_id = entry_sponsor(entry)
    if old_sponsor_id is None:
        raise SponsorshipError("transferring unsponsored entry")
    header = ltx.header()
    mult = compute_multiplier(entry)
    old_entry = ltx.load_account(old_sponsor_id)
    new_entry = ltx.load_account(new_sponsor_id)
    old = old_entry.data.value
    new = new_entry.data.value
    res = _can_remove(header, old, None, mult)
    if res != SponsorshipResult.SUCCESS:
        return res, entry
    res = _can_establish(header, new, None, mult)
    if res != SponsorshipResult.SUCCESS:
        return res, entry
    _put_account(ltx, old_entry, add_num_sponsoring(old, -mult))
    # re-load in case old == new account (no-op transfer keeps counts sane)
    new_entry = ltx.load_account(new_sponsor_id)
    new = new_entry.data.value
    _put_account(ltx, new_entry, add_num_sponsoring(new, mult))
    return SponsorshipResult.SUCCESS, set_entry_sponsor(entry,
                                                        new_sponsor_id)


# -- signer sponsorship (ref :302-470) ---------------------------------------

def create_signer_with_possible_sponsorship(
        ltx, owner_entry, owner_id: bytes) -> Tuple[int, Optional[bytes]]:
    """Reserve check + count updates for adding one signer to owner.

    Returns (SponsorshipResult, sponsor_id_or_None).  Count changes for the
    sponsor are written through ltx; the owner's numSubEntries increment and
    the signerSponsoringIDs insert are the caller's job (it is already
    rewriting the signers list)."""
    header = ltx.header()
    owner = owner_entry.data.value
    sponsor_id = load_sponsorship(ltx, owner_id)
    if sponsor_id is None:
        if _too_many_subentries(owner, 1):
            return SponsorshipResult.TOO_MANY_SUBENTRIES, None
        if U.get_available_balance(header, owner) < header.baseReserve:
            return SponsorshipResult.LOW_RESERVE, None
        return SponsorshipResult.SUCCESS, None
    sponsoring_entry = ltx.load_account(sponsor_id)
    if sponsoring_entry is None:
        raise SponsorshipError("sponsoring account missing")
    sponsoring = sponsoring_entry.data.value
    if _too_many_subentries(owner, 1):
        return SponsorshipResult.TOO_MANY_SUBENTRIES, None
    res = _can_establish(header, sponsoring, owner, 1)
    if res != SponsorshipResult.SUCCESS:
        return res, None
    _put_account(ltx, sponsoring_entry, add_num_sponsoring(sponsoring, 1))
    return SponsorshipResult.SUCCESS, sponsor_id


def release_signer_sponsorship(ltx, sponsor_id: Optional[bytes]) -> None:
    """Release one signer's reserve from its sponsor (owner-side numSponsored
    decrement is the caller's job alongside the list edit)."""
    if sponsor_id is None:
        return
    sponsoring_entry = ltx.load_account(sponsor_id)
    if sponsoring_entry is None:
        return
    sponsoring = sponsoring_entry.data.value
    if U.num_sponsoring(sponsoring) < 1:
        raise SponsorshipError("invalid sponsoring account state")
    _put_account(ltx, sponsoring_entry, add_num_sponsoring(sponsoring, -1))


def _put_account(ltx, entry, acc) -> None:
    ltx.put(entry._replace(
        data=T.LedgerEntryData.make(T.LedgerEntryType.ACCOUNT, acc)))
