"""Protocol-upgrade voting + validation
(ref src/herder/Upgrades.{h,cpp} — createUpgradesFor :79, applyTo :83,
isValidForApply :101/:511).

Upgrades ride externalized StellarValues as opaque XDR blobs; a node
validates each REMOTE upgrade against its own policy before applying
(invalid ones are skipped, not fatal), and proposes its own configured
upgrades when nominating."""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..xdr import types as T

VALID = 0
INVALID = 1
XDR_INVALID = 2

UT = T.LedgerUpgradeType


def is_valid_for_apply(raw: bytes, header, cfg) -> Tuple[int, object]:
    """Validate one opaque upgrade blob against the current header
    (ref Upgrades::isValidForApply :511).  Returns (validity, upgrade)."""
    try:
        upgrade = T.LedgerUpgrade.decode(raw)
    except Exception:
        return XDR_INVALID, None
    t = upgrade.type
    ok = True
    if t == UT.LEDGER_UPGRADE_VERSION:
        new_version = upgrade.value
        ok = (new_version <= cfg.LEDGER_PROTOCOL_VERSION
              and new_version > header.ledgerVersion)
    elif t == UT.LEDGER_UPGRADE_BASE_FEE:
        ok = upgrade.value != 0
    elif t == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
        ok = True
    elif t == UT.LEDGER_UPGRADE_BASE_RESERVE:
        ok = upgrade.value != 0
    elif t == UT.LEDGER_UPGRADE_FLAGS:
        ok = (header.ledgerVersion >= 18
              and (upgrade.value & ~T.MASK_LEDGER_HEADER_FLAGS) == 0)
    else:
        ok = False
    return (VALID if ok else INVALID), upgrade


def create_upgrades_for(header, cfg) -> List[bytes]:
    """Upgrades this node wants to propose: the configured desired values
    that differ from the current header (ref createUpgradesFor :79; the
    TESTING_UPGRADE_* knobs mirror getTestConfig's desired params)."""
    out: List[bytes] = []
    desired_version: Optional[int] = getattr(
        cfg, "UPGRADE_DESIRED_PROTOCOL_VERSION", None)
    if desired_version and desired_version > header.ledgerVersion:
        out.append(T.LedgerUpgrade.encode(T.LedgerUpgrade.make(
            UT.LEDGER_UPGRADE_VERSION, desired_version)))
    desired_fee = getattr(cfg, "UPGRADE_DESIRED_BASE_FEE", None)
    if desired_fee and desired_fee != header.baseFee:
        out.append(T.LedgerUpgrade.encode(T.LedgerUpgrade.make(
            UT.LEDGER_UPGRADE_BASE_FEE, desired_fee)))
    desired_size = getattr(cfg, "UPGRADE_DESIRED_MAX_TX_SET_SIZE", None)
    if desired_size and desired_size != header.maxTxSetSize:
        out.append(T.LedgerUpgrade.encode(T.LedgerUpgrade.make(
            UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE, desired_size)))
    desired_reserve = getattr(cfg, "UPGRADE_DESIRED_BASE_RESERVE", None)
    if desired_reserve and desired_reserve != header.baseReserve:
        out.append(T.LedgerUpgrade.encode(T.LedgerUpgrade.make(
            UT.LEDGER_UPGRADE_BASE_RESERVE, desired_reserve)))
    return out
