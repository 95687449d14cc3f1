"""Stellar protocol schema (protocol 19) declared over the XDR runtime.

Equivalent of the reference's generated codecs for the protocol ``.x`` files
(ref src/protocol-curr/xdr/Stellar-{types,ledger-entries,transaction,ledger,
SCP}.x; codegen ref src/Makefile.am:42-47).  Declarations follow the wire
format exactly — field order and discriminant values are the protocol spec —
but the runtime/object model is this framework's own (combinators +
generic records, see runtime.py).

Naming: type objects are UpperCamel like the protocol; enums expose their
members as attributes (``OperationType.PAYMENT``).
"""
from __future__ import annotations

from .runtime import (
    Bool, Enum, FixedArray, Hyper, Int, Lazy, Opaque, Option, Struct, Uhyper,
    Uint, Union, VarArray, VarOpaque, XdrStr,
)

# ---------------------------------------------------------------------------
# Stellar-types.x
# ---------------------------------------------------------------------------

Hash = Opaque(32)
Uint256 = Opaque(32)
Signature = VarOpaque(64)
SignatureHint = Opaque(4)

ExtensionPoint = Union("ExtensionPoint", Int, {0: ("v0", None)})

CryptoKeyType = Enum("CryptoKeyType", {
    "KEY_TYPE_ED25519": 0,
    "KEY_TYPE_PRE_AUTH_TX": 1,
    "KEY_TYPE_HASH_X": 2,
    "KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
    "KEY_TYPE_MUXED_ED25519": 0x100,
})

PublicKeyType = Enum("PublicKeyType", {"PUBLIC_KEY_TYPE_ED25519": 0})

SignerKeyType = Enum("SignerKeyType", {
    "SIGNER_KEY_TYPE_ED25519": 0,
    "SIGNER_KEY_TYPE_PRE_AUTH_TX": 1,
    "SIGNER_KEY_TYPE_HASH_X": 2,
    "SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD": 3,
})

PublicKey = Union("PublicKey", PublicKeyType, {
    PublicKeyType.PUBLIC_KEY_TYPE_ED25519: ("ed25519", Uint256),
})

_Ed25519SignedPayload = Struct("Ed25519SignedPayload", [
    ("ed25519", Uint256),
    ("payload", VarOpaque(64)),
])

SignerKey = Union("SignerKey", SignerKeyType, {
    SignerKeyType.SIGNER_KEY_TYPE_ED25519: ("ed25519", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX: ("preAuthTx", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_HASH_X: ("hashX", Uint256),
    SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD:
        ("ed25519SignedPayload", _Ed25519SignedPayload),
})

NodeID = PublicKey
AccountID = PublicKey

Curve25519Public = Struct("Curve25519Public", [("key", Opaque(32))])
Curve25519Secret = Struct("Curve25519Secret", [("key", Opaque(32))])
HmacSha256Key = Struct("HmacSha256Key", [("key", Opaque(32))])
HmacSha256Mac = Struct("HmacSha256Mac", [("mac", Opaque(32))])


def account_id(ed25519_bytes: bytes):
    """Convenience: raw 32-byte key -> AccountID value."""
    return PublicKey.make(PublicKeyType.PUBLIC_KEY_TYPE_ED25519, ed25519_bytes)


# ---------------------------------------------------------------------------
# Stellar-ledger-entries.x
# ---------------------------------------------------------------------------

Thresholds = Opaque(4)
String32 = XdrStr(32)
String64 = XdrStr(64)
DataValue = VarOpaque(64)
PoolID = Hash
AssetCode4 = Opaque(4)
AssetCode12 = Opaque(12)

AssetType = Enum("AssetType", {
    "ASSET_TYPE_NATIVE": 0,
    "ASSET_TYPE_CREDIT_ALPHANUM4": 1,
    "ASSET_TYPE_CREDIT_ALPHANUM12": 2,
    "ASSET_TYPE_POOL_SHARE": 3,
})

AssetCode = Union("AssetCode", AssetType, {
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("assetCode4", AssetCode4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("assetCode12", AssetCode12),
})

AlphaNum4 = Struct("AlphaNum4", [
    ("assetCode", AssetCode4), ("issuer", AccountID),
])
AlphaNum12 = Struct("AlphaNum12", [
    ("assetCode", AssetCode12), ("issuer", AccountID),
])

Asset = Union("Asset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
})

Price = Struct("Price", [("n", Int), ("d", Int)])
Liabilities = Struct("Liabilities", [("buying", Hyper), ("selling", Hyper)])

ThresholdIndexes = Enum("ThresholdIndexes", {
    "THRESHOLD_MASTER_WEIGHT": 0,
    "THRESHOLD_LOW": 1,
    "THRESHOLD_MED": 2,
    "THRESHOLD_HIGH": 3,
})

LedgerEntryType = Enum("LedgerEntryType", {
    "ACCOUNT": 0,
    "TRUSTLINE": 1,
    "OFFER": 2,
    "DATA": 3,
    "CLAIMABLE_BALANCE": 4,
    "LIQUIDITY_POOL": 5,
})

Signer = Struct("Signer", [("key", SignerKey), ("weight", Uint)])

AUTH_REQUIRED_FLAG = 0x1
AUTH_REVOCABLE_FLAG = 0x2
AUTH_IMMUTABLE_FLAG = 0x4
AUTH_CLAWBACK_ENABLED_FLAG = 0x8
MASK_ACCOUNT_FLAGS = 0x7
MASK_ACCOUNT_FLAGS_V17 = 0xF
MAX_SIGNERS = 20

SponsorshipDescriptor = Option(AccountID)

AccountEntryExtensionV3 = Struct("AccountEntryExtensionV3", [
    ("ext", ExtensionPoint),
    ("seqLedger", Uint),
    ("seqTime", Uhyper),
])

AccountEntryExtensionV2 = Struct("AccountEntryExtensionV2", [
    ("numSponsored", Uint),
    ("numSponsoring", Uint),
    ("signerSponsoringIDs", VarArray(SponsorshipDescriptor, MAX_SIGNERS)),
    ("ext", Union("AccountEntryExtensionV2Ext", Int, {
        0: ("v0", None),
        3: ("v3", AccountEntryExtensionV3),
    })),
])

AccountEntryExtensionV1 = Struct("AccountEntryExtensionV1", [
    ("liabilities", Liabilities),
    ("ext", Union("AccountEntryExtensionV1Ext", Int, {
        0: ("v0", None),
        2: ("v2", AccountEntryExtensionV2),
    })),
])

AccountEntry = Struct("AccountEntry", [
    ("accountID", AccountID),
    ("balance", Hyper),
    ("seqNum", Hyper),
    ("numSubEntries", Uint),
    ("inflationDest", Option(AccountID)),
    ("flags", Uint),
    ("homeDomain", String32),
    ("thresholds", Thresholds),
    ("signers", VarArray(Signer, MAX_SIGNERS)),
    ("ext", Union("AccountEntryExt", Int, {
        0: ("v0", None),
        1: ("v1", AccountEntryExtensionV1),
    })),
])

AUTHORIZED_FLAG = 1
AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG = 2
TRUSTLINE_CLAWBACK_ENABLED_FLAG = 4
MASK_TRUSTLINE_FLAGS = 1
MASK_TRUSTLINE_FLAGS_V13 = 3
MASK_TRUSTLINE_FLAGS_V17 = 7

LiquidityPoolType = Enum("LiquidityPoolType", {
    "LIQUIDITY_POOL_CONSTANT_PRODUCT": 0,
})

TrustLineAsset = Union("TrustLineAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
    AssetType.ASSET_TYPE_POOL_SHARE: ("liquidityPoolID", PoolID),
})

TrustLineEntryExtensionV2 = Struct("TrustLineEntryExtensionV2", [
    ("liquidityPoolUseCount", Int),
    ("ext", Union("TrustLineEntryExtensionV2Ext", Int, {0: ("v0", None)})),
])

_TrustLineEntryV1 = Struct("TrustLineEntryV1", [
    ("liabilities", Liabilities),
    ("ext", Union("TrustLineEntryV1Ext", Int, {
        0: ("v0", None),
        2: ("v2", TrustLineEntryExtensionV2),
    })),
])

TrustLineEntry = Struct("TrustLineEntry", [
    ("accountID", AccountID),
    ("asset", TrustLineAsset),
    ("balance", Hyper),
    ("limit", Hyper),
    ("flags", Uint),
    ("ext", Union("TrustLineEntryExt", Int, {
        0: ("v0", None),
        1: ("v1", _TrustLineEntryV1),
    })),
])

PASSIVE_FLAG = 1
MASK_OFFERENTRY_FLAGS = 1

OfferEntry = Struct("OfferEntry", [
    ("sellerID", AccountID),
    ("offerID", Hyper),
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Hyper),
    ("price", Price),
    ("flags", Uint),
    ("ext", Union("OfferEntryExt", Int, {0: ("v0", None)})),
])

DataEntry = Struct("DataEntry", [
    ("accountID", AccountID),
    ("dataName", String64),
    ("dataValue", DataValue),
    ("ext", Union("DataEntryExt", Int, {0: ("v0", None)})),
])

ClaimPredicateType = Enum("ClaimPredicateType", {
    "CLAIM_PREDICATE_UNCONDITIONAL": 0,
    "CLAIM_PREDICATE_AND": 1,
    "CLAIM_PREDICATE_OR": 2,
    "CLAIM_PREDICATE_NOT": 3,
    "CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME": 4,
    "CLAIM_PREDICATE_BEFORE_RELATIVE_TIME": 5,
})

ClaimPredicate = Union("ClaimPredicate", ClaimPredicateType, {
    ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL: ("unconditional", None),
    ClaimPredicateType.CLAIM_PREDICATE_AND:
        ("andPredicates", VarArray(Lazy(lambda: ClaimPredicate), 2)),
    ClaimPredicateType.CLAIM_PREDICATE_OR:
        ("orPredicates", VarArray(Lazy(lambda: ClaimPredicate), 2)),
    ClaimPredicateType.CLAIM_PREDICATE_NOT:
        ("notPredicate", Option(Lazy(lambda: ClaimPredicate))),
    ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        ("absBefore", Hyper),
    ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        ("relBefore", Hyper),
})

ClaimantType = Enum("ClaimantType", {"CLAIMANT_TYPE_V0": 0})

_ClaimantV0 = Struct("ClaimantV0", [
    ("destination", AccountID),
    ("predicate", ClaimPredicate),
])

Claimant = Union("Claimant", ClaimantType, {
    ClaimantType.CLAIMANT_TYPE_V0: ("v0", _ClaimantV0),
})

ClaimableBalanceIDType = Enum("ClaimableBalanceIDType", {
    "CLAIMABLE_BALANCE_ID_TYPE_V0": 0,
})

ClaimableBalanceID = Union("ClaimableBalanceID", ClaimableBalanceIDType, {
    ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0: ("v0", Hash),
})

CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG = 0x1
MASK_CLAIMABLE_BALANCE_FLAGS = 0x1

ClaimableBalanceEntryExtensionV1 = Struct("ClaimableBalanceEntryExtensionV1", [
    ("ext", Union("ClaimableBalanceEntryExtensionV1Ext", Int,
                  {0: ("v0", None)})),
    ("flags", Uint),
])

ClaimableBalanceEntry = Struct("ClaimableBalanceEntry", [
    ("balanceID", ClaimableBalanceID),
    ("claimants", VarArray(Claimant, 10)),
    ("asset", Asset),
    ("amount", Hyper),
    ("ext", Union("ClaimableBalanceEntryExt", Int, {
        0: ("v0", None),
        1: ("v1", ClaimableBalanceEntryExtensionV1),
    })),
])

LiquidityPoolConstantProductParameters = Struct(
    "LiquidityPoolConstantProductParameters", [
        ("assetA", Asset),
        ("assetB", Asset),
        ("fee", Int),
    ])

LIQUIDITY_POOL_FEE_V18 = 30

_LPConstantProduct = Struct("LiquidityPoolEntryConstantProduct", [
    ("params", LiquidityPoolConstantProductParameters),
    ("reserveA", Hyper),
    ("reserveB", Hyper),
    ("totalPoolShares", Hyper),
    ("poolSharesTrustLineCount", Hyper),
])

LiquidityPoolEntry = Struct("LiquidityPoolEntry", [
    ("liquidityPoolID", PoolID),
    ("body", Union("LiquidityPoolEntryBody", LiquidityPoolType, {
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
            ("constantProduct", _LPConstantProduct),
    })),
])

LedgerEntryExtensionV1 = Struct("LedgerEntryExtensionV1", [
    ("sponsoringID", SponsorshipDescriptor),
    ("ext", Union("LedgerEntryExtensionV1Ext", Int, {0: ("v0", None)})),
])

LedgerEntryData = Union("LedgerEntryData", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: ("account", AccountEntry),
    LedgerEntryType.TRUSTLINE: ("trustLine", TrustLineEntry),
    LedgerEntryType.OFFER: ("offer", OfferEntry),
    LedgerEntryType.DATA: ("data", DataEntry),
    LedgerEntryType.CLAIMABLE_BALANCE:
        ("claimableBalance", ClaimableBalanceEntry),
    LedgerEntryType.LIQUIDITY_POOL: ("liquidityPool", LiquidityPoolEntry),
})

LedgerEntry = Struct("LedgerEntry", [
    ("lastModifiedLedgerSeq", Uint),
    ("data", LedgerEntryData),
    ("ext", Union("LedgerEntryExt", Int, {
        0: ("v0", None),
        1: ("v1", LedgerEntryExtensionV1),
    })),
])
# one LedgerEntry flows through tx meta + bucket list + SQL commit per
# close; memoized encoding collapses those to a single pack (values are
# immutable-by-convention: all mutation goes through _replace)
LedgerEntry.memoize = True

_LKAccount = Struct("LedgerKeyAccount", [("accountID", AccountID)])
_LKTrustLine = Struct("LedgerKeyTrustLine", [
    ("accountID", AccountID), ("asset", TrustLineAsset),
])
_LKOffer = Struct("LedgerKeyOffer", [
    ("sellerID", AccountID), ("offerID", Hyper),
])
_LKData = Struct("LedgerKeyData", [
    ("accountID", AccountID), ("dataName", String64),
])
_LKClaimableBalance = Struct("LedgerKeyClaimableBalance", [
    ("balanceID", ClaimableBalanceID),
])
_LKLiquidityPool = Struct("LedgerKeyLiquidityPool", [
    ("liquidityPoolID", PoolID),
])

LedgerKey = Union("LedgerKey", LedgerEntryType, {
    LedgerEntryType.ACCOUNT: ("account", _LKAccount),
    LedgerEntryType.TRUSTLINE: ("trustLine", _LKTrustLine),
    LedgerEntryType.OFFER: ("offer", _LKOffer),
    LedgerEntryType.DATA: ("data", _LKData),
    LedgerEntryType.CLAIMABLE_BALANCE:
        ("claimableBalance", _LKClaimableBalance),
    LedgerEntryType.LIQUIDITY_POOL: ("liquidityPool", _LKLiquidityPool),
})

EnvelopeType = Enum("EnvelopeType", {
    "ENVELOPE_TYPE_TX_V0": 0,
    "ENVELOPE_TYPE_SCP": 1,
    "ENVELOPE_TYPE_TX": 2,
    "ENVELOPE_TYPE_AUTH": 3,
    "ENVELOPE_TYPE_SCPVALUE": 4,
    "ENVELOPE_TYPE_TX_FEE_BUMP": 5,
    "ENVELOPE_TYPE_OP_ID": 6,
    "ENVELOPE_TYPE_POOL_REVOKE_OP_ID": 7,
})

# ---------------------------------------------------------------------------
# Stellar-transaction.x — operations
# ---------------------------------------------------------------------------

LiquidityPoolParameters = Union(
    "LiquidityPoolParameters", LiquidityPoolType, {
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
            ("constantProduct", LiquidityPoolConstantProductParameters),
    })

_MuxedEd25519 = Struct("MuxedEd25519", [
    ("id", Uhyper), ("ed25519", Uint256),
])

MuxedAccount = Union("MuxedAccount", CryptoKeyType, {
    CryptoKeyType.KEY_TYPE_ED25519: ("ed25519", Uint256),
    CryptoKeyType.KEY_TYPE_MUXED_ED25519: ("med25519", _MuxedEd25519),
})


def muxed_account(ed25519_bytes: bytes):
    return MuxedAccount.make(CryptoKeyType.KEY_TYPE_ED25519, ed25519_bytes)


DecoratedSignature = Struct("DecoratedSignature", [
    ("hint", SignatureHint),
    ("signature", Signature),
])

OperationType = Enum("OperationType", {
    "CREATE_ACCOUNT": 0,
    "PAYMENT": 1,
    "PATH_PAYMENT_STRICT_RECEIVE": 2,
    "MANAGE_SELL_OFFER": 3,
    "CREATE_PASSIVE_SELL_OFFER": 4,
    "SET_OPTIONS": 5,
    "CHANGE_TRUST": 6,
    "ALLOW_TRUST": 7,
    "ACCOUNT_MERGE": 8,
    "INFLATION": 9,
    "MANAGE_DATA": 10,
    "BUMP_SEQUENCE": 11,
    "MANAGE_BUY_OFFER": 12,
    "PATH_PAYMENT_STRICT_SEND": 13,
    "CREATE_CLAIMABLE_BALANCE": 14,
    "CLAIM_CLAIMABLE_BALANCE": 15,
    "BEGIN_SPONSORING_FUTURE_RESERVES": 16,
    "END_SPONSORING_FUTURE_RESERVES": 17,
    "REVOKE_SPONSORSHIP": 18,
    "CLAWBACK": 19,
    "CLAWBACK_CLAIMABLE_BALANCE": 20,
    "SET_TRUST_LINE_FLAGS": 21,
    "LIQUIDITY_POOL_DEPOSIT": 22,
    "LIQUIDITY_POOL_WITHDRAW": 23,
})

CreateAccountOp = Struct("CreateAccountOp", [
    ("destination", AccountID),
    ("startingBalance", Hyper),
])

PaymentOp = Struct("PaymentOp", [
    ("destination", MuxedAccount),
    ("asset", Asset),
    ("amount", Hyper),
])

PathPaymentStrictReceiveOp = Struct("PathPaymentStrictReceiveOp", [
    ("sendAsset", Asset),
    ("sendMax", Hyper),
    ("destination", MuxedAccount),
    ("destAsset", Asset),
    ("destAmount", Hyper),
    ("path", VarArray(Asset, 5)),
])

PathPaymentStrictSendOp = Struct("PathPaymentStrictSendOp", [
    ("sendAsset", Asset),
    ("sendAmount", Hyper),
    ("destination", MuxedAccount),
    ("destAsset", Asset),
    ("destMin", Hyper),
    ("path", VarArray(Asset, 5)),
])

ManageSellOfferOp = Struct("ManageSellOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Hyper),
    ("price", Price),
    ("offerID", Hyper),
])

ManageBuyOfferOp = Struct("ManageBuyOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("buyAmount", Hyper),
    ("price", Price),
    ("offerID", Hyper),
])

CreatePassiveSellOfferOp = Struct("CreatePassiveSellOfferOp", [
    ("selling", Asset),
    ("buying", Asset),
    ("amount", Hyper),
    ("price", Price),
])

SetOptionsOp = Struct("SetOptionsOp", [
    ("inflationDest", Option(AccountID)),
    ("clearFlags", Option(Uint)),
    ("setFlags", Option(Uint)),
    ("masterWeight", Option(Uint)),
    ("lowThreshold", Option(Uint)),
    ("medThreshold", Option(Uint)),
    ("highThreshold", Option(Uint)),
    ("homeDomain", Option(String32)),
    ("signer", Option(Signer)),
])

ChangeTrustAsset = Union("ChangeTrustAsset", AssetType, {
    AssetType.ASSET_TYPE_NATIVE: ("native", None),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
    AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
    AssetType.ASSET_TYPE_POOL_SHARE:
        ("liquidityPool", LiquidityPoolParameters),
})

ChangeTrustOp = Struct("ChangeTrustOp", [
    ("line", ChangeTrustAsset),
    ("limit", Hyper),
])

AllowTrustOp = Struct("AllowTrustOp", [
    ("trustor", AccountID),
    ("asset", AssetCode),
    ("authorize", Uint),
])

ManageDataOp = Struct("ManageDataOp", [
    ("dataName", String64),
    ("dataValue", Option(DataValue)),
])

BumpSequenceOp = Struct("BumpSequenceOp", [("bumpTo", Hyper)])

CreateClaimableBalanceOp = Struct("CreateClaimableBalanceOp", [
    ("asset", Asset),
    ("amount", Hyper),
    ("claimants", VarArray(Claimant, 10)),
])

ClaimClaimableBalanceOp = Struct("ClaimClaimableBalanceOp", [
    ("balanceID", ClaimableBalanceID),
])

BeginSponsoringFutureReservesOp = Struct(
    "BeginSponsoringFutureReservesOp", [("sponsoredID", AccountID)])

RevokeSponsorshipType = Enum("RevokeSponsorshipType", {
    "REVOKE_SPONSORSHIP_LEDGER_ENTRY": 0,
    "REVOKE_SPONSORSHIP_SIGNER": 1,
})

_RevokeSponsorshipSigner = Struct("RevokeSponsorshipSigner", [
    ("accountID", AccountID),
    ("signerKey", SignerKey),
])

RevokeSponsorshipOp = Union("RevokeSponsorshipOp", RevokeSponsorshipType, {
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
        ("ledgerKey", LedgerKey),
    RevokeSponsorshipType.REVOKE_SPONSORSHIP_SIGNER:
        ("signer", _RevokeSponsorshipSigner),
})

ClawbackOp = Struct("ClawbackOp", [
    ("asset", Asset),
    ("from_", MuxedAccount),
    ("amount", Hyper),
])

ClawbackClaimableBalanceOp = Struct("ClawbackClaimableBalanceOp", [
    ("balanceID", ClaimableBalanceID),
])

SetTrustLineFlagsOp = Struct("SetTrustLineFlagsOp", [
    ("trustor", AccountID),
    ("asset", Asset),
    ("clearFlags", Uint),
    ("setFlags", Uint),
])

LiquidityPoolDepositOp = Struct("LiquidityPoolDepositOp", [
    ("liquidityPoolID", PoolID),
    ("maxAmountA", Hyper),
    ("maxAmountB", Hyper),
    ("minPrice", Price),
    ("maxPrice", Price),
])

LiquidityPoolWithdrawOp = Struct("LiquidityPoolWithdrawOp", [
    ("liquidityPoolID", PoolID),
    ("amount", Hyper),
    ("minAmountA", Hyper),
    ("minAmountB", Hyper),
])

OperationBody = Union("OperationBody", OperationType, {
    OperationType.CREATE_ACCOUNT: ("createAccountOp", CreateAccountOp),
    OperationType.PAYMENT: ("paymentOp", PaymentOp),
    OperationType.PATH_PAYMENT_STRICT_RECEIVE:
        ("pathPaymentStrictReceiveOp", PathPaymentStrictReceiveOp),
    OperationType.MANAGE_SELL_OFFER:
        ("manageSellOfferOp", ManageSellOfferOp),
    OperationType.CREATE_PASSIVE_SELL_OFFER:
        ("createPassiveSellOfferOp", CreatePassiveSellOfferOp),
    OperationType.SET_OPTIONS: ("setOptionsOp", SetOptionsOp),
    OperationType.CHANGE_TRUST: ("changeTrustOp", ChangeTrustOp),
    OperationType.ALLOW_TRUST: ("allowTrustOp", AllowTrustOp),
    OperationType.ACCOUNT_MERGE: ("destination", MuxedAccount),
    OperationType.INFLATION: ("inflation", None),
    OperationType.MANAGE_DATA: ("manageDataOp", ManageDataOp),
    OperationType.BUMP_SEQUENCE: ("bumpSequenceOp", BumpSequenceOp),
    OperationType.MANAGE_BUY_OFFER: ("manageBuyOfferOp", ManageBuyOfferOp),
    OperationType.PATH_PAYMENT_STRICT_SEND:
        ("pathPaymentStrictSendOp", PathPaymentStrictSendOp),
    OperationType.CREATE_CLAIMABLE_BALANCE:
        ("createClaimableBalanceOp", CreateClaimableBalanceOp),
    OperationType.CLAIM_CLAIMABLE_BALANCE:
        ("claimClaimableBalanceOp", ClaimClaimableBalanceOp),
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        ("beginSponsoringFutureReservesOp", BeginSponsoringFutureReservesOp),
    OperationType.END_SPONSORING_FUTURE_RESERVES:
        ("endSponsoringFutureReserves", None),
    OperationType.REVOKE_SPONSORSHIP:
        ("revokeSponsorshipOp", RevokeSponsorshipOp),
    OperationType.CLAWBACK: ("clawbackOp", ClawbackOp),
    OperationType.CLAWBACK_CLAIMABLE_BALANCE:
        ("clawbackClaimableBalanceOp", ClawbackClaimableBalanceOp),
    OperationType.SET_TRUST_LINE_FLAGS:
        ("setTrustLineFlagsOp", SetTrustLineFlagsOp),
    OperationType.LIQUIDITY_POOL_DEPOSIT:
        ("liquidityPoolDepositOp", LiquidityPoolDepositOp),
    OperationType.LIQUIDITY_POOL_WITHDRAW:
        ("liquidityPoolWithdrawOp", LiquidityPoolWithdrawOp),
})

Operation = Struct("Operation", [
    ("sourceAccount", Option(MuxedAccount)),
    ("body", OperationBody),
])

_HashIDPreimageOperationID = Struct("HashIDPreimageOperationID", [
    ("sourceAccount", AccountID),
    ("seqNum", Hyper),
    ("opNum", Uint),
])

_HashIDPreimageRevokeID = Struct("HashIDPreimageRevokeID", [
    ("sourceAccount", AccountID),
    ("seqNum", Hyper),
    ("opNum", Uint),
    ("liquidityPoolID", PoolID),
    ("asset", Asset),
])

HashIDPreimage = Union("HashIDPreimage", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_OP_ID:
        ("operationID", _HashIDPreimageOperationID),
    EnvelopeType.ENVELOPE_TYPE_POOL_REVOKE_OP_ID:
        ("revokeID", _HashIDPreimageRevokeID),
})

MemoType = Enum("MemoType", {
    "MEMO_NONE": 0,
    "MEMO_TEXT": 1,
    "MEMO_ID": 2,
    "MEMO_HASH": 3,
    "MEMO_RETURN": 4,
})

Memo = Union("Memo", MemoType, {
    MemoType.MEMO_NONE: ("none", None),
    MemoType.MEMO_TEXT: ("text", XdrStr(28)),
    MemoType.MEMO_ID: ("id", Uhyper),
    MemoType.MEMO_HASH: ("hash", Hash),
    MemoType.MEMO_RETURN: ("retHash", Hash),
})

MEMO_NONE_VALUE = Memo.make(MemoType.MEMO_NONE)

TimeBounds = Struct("TimeBounds", [
    ("minTime", Uhyper),
    ("maxTime", Uhyper),
])

LedgerBounds = Struct("LedgerBounds", [
    ("minLedger", Uint),
    ("maxLedger", Uint),
])

PreconditionsV2 = Struct("PreconditionsV2", [
    ("timeBounds", Option(TimeBounds)),
    ("ledgerBounds", Option(LedgerBounds)),
    ("minSeqNum", Option(Hyper)),
    ("minSeqAge", Uhyper),
    ("minSeqLedgerGap", Uint),
    ("extraSigners", VarArray(SignerKey, 2)),
])

PreconditionType = Enum("PreconditionType", {
    "PRECOND_NONE": 0,
    "PRECOND_TIME": 1,
    "PRECOND_V2": 2,
})

Preconditions = Union("Preconditions", PreconditionType, {
    PreconditionType.PRECOND_NONE: ("none", None),
    PreconditionType.PRECOND_TIME: ("timeBounds", TimeBounds),
    PreconditionType.PRECOND_V2: ("v2", PreconditionsV2),
})

MAX_OPS_PER_TX = 100

TransactionV0 = Struct("TransactionV0", [
    ("sourceAccountEd25519", Uint256),
    ("fee", Uint),
    ("seqNum", Hyper),
    ("timeBounds", Option(TimeBounds)),
    ("memo", Memo),
    ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
    ("ext", Union("TransactionV0Ext", Int, {0: ("v0", None)})),
])

TransactionV0Envelope = Struct("TransactionV0Envelope", [
    ("tx", TransactionV0),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

Transaction = Struct("Transaction", [
    ("sourceAccount", MuxedAccount),
    ("fee", Uint),
    ("seqNum", Hyper),
    ("cond", Preconditions),
    ("memo", Memo),
    ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
    ("ext", Union("TransactionExt", Int, {0: ("v0", None)})),
])

TransactionV1Envelope = Struct("TransactionV1Envelope", [
    ("tx", Transaction),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

FeeBumpTransaction = Struct("FeeBumpTransaction", [
    ("feeSource", MuxedAccount),
    ("fee", Hyper),
    ("innerTx", Union("FeeBumpInnerTx", EnvelopeType, {
        EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
    })),
    ("ext", Union("FeeBumpTransactionExt", Int, {0: ("v0", None)})),
])

FeeBumpTransactionEnvelope = Struct("FeeBumpTransactionEnvelope", [
    ("tx", FeeBumpTransaction),
    ("signatures", VarArray(DecoratedSignature, 20)),
])

TransactionEnvelope = Union("TransactionEnvelope", EnvelopeType, {
    EnvelopeType.ENVELOPE_TYPE_TX_V0: ("v0", TransactionV0Envelope),
    EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
    EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
        ("feeBump", FeeBumpTransactionEnvelope),
})
# an envelope is encoded at admission (hash), flood, tx-set hashing, and
# tx-history persistence — memoize like LedgerEntry
TransactionEnvelope.memoize = True

TransactionSignaturePayload = Struct("TransactionSignaturePayload", [
    ("networkId", Hash),
    ("taggedTransaction",
     Union("TaggedTransaction", EnvelopeType, {
         EnvelopeType.ENVELOPE_TYPE_TX: ("tx", Transaction),
         EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
             ("feeBump", FeeBumpTransaction),
     })),
])

# ---------------------------------------------------------------------------
# Stellar-transaction.x — results
# ---------------------------------------------------------------------------

ClaimAtomType = Enum("ClaimAtomType", {
    "CLAIM_ATOM_TYPE_V0": 0,
    "CLAIM_ATOM_TYPE_ORDER_BOOK": 1,
    "CLAIM_ATOM_TYPE_LIQUIDITY_POOL": 2,
})

ClaimOfferAtomV0 = Struct("ClaimOfferAtomV0", [
    ("sellerEd25519", Uint256),
    ("offerID", Hyper),
    ("assetSold", Asset),
    ("amountSold", Hyper),
    ("assetBought", Asset),
    ("amountBought", Hyper),
])

ClaimOfferAtom = Struct("ClaimOfferAtom", [
    ("sellerID", AccountID),
    ("offerID", Hyper),
    ("assetSold", Asset),
    ("amountSold", Hyper),
    ("assetBought", Asset),
    ("amountBought", Hyper),
])

ClaimLiquidityAtom = Struct("ClaimLiquidityAtom", [
    ("liquidityPoolID", PoolID),
    ("assetSold", Asset),
    ("amountSold", Hyper),
    ("assetBought", Asset),
    ("amountBought", Hyper),
])

ClaimAtom = Union("ClaimAtom", ClaimAtomType, {
    ClaimAtomType.CLAIM_ATOM_TYPE_V0: ("v0", ClaimOfferAtomV0),
    ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK: ("orderBook", ClaimOfferAtom),
    ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL:
        ("liquidityPool", ClaimLiquidityAtom),
})


def _result_enum(name: str, success_names, failure_names):
    """Result-code enum: successes from 0 up-order as listed with their
    index semantics (first success = 0, second = 1 only for tx codes);
    failures numbered -1, -2, ... in listed order."""
    values = {}
    for i, n in enumerate(success_names):
        values[n] = i
    for i, n in enumerate(failure_names):
        values[n] = -(i + 1)
    return Enum(name, values)


def _simple_result(name: str, code_enum: Enum,
                   special: dict = None) -> Union:
    """Result union where most arms are void; ``special`` maps code->arm."""
    arms = {}
    for code_name, v in code_enum.by_name.items():
        if special and v in special:
            arms[v] = special[v]
        else:
            arms[v] = (code_name.lower(), None)
    return Union(name, code_enum, arms)


CreateAccountResultCode = _result_enum(
    "CreateAccountResultCode",
    ["CREATE_ACCOUNT_SUCCESS"],
    ["CREATE_ACCOUNT_MALFORMED", "CREATE_ACCOUNT_UNDERFUNDED",
     "CREATE_ACCOUNT_LOW_RESERVE", "CREATE_ACCOUNT_ALREADY_EXIST"])
CreateAccountResult = _simple_result(
    "CreateAccountResult", CreateAccountResultCode)

PaymentResultCode = _result_enum(
    "PaymentResultCode",
    ["PAYMENT_SUCCESS"],
    ["PAYMENT_MALFORMED", "PAYMENT_UNDERFUNDED", "PAYMENT_SRC_NO_TRUST",
     "PAYMENT_SRC_NOT_AUTHORIZED", "PAYMENT_NO_DESTINATION",
     "PAYMENT_NO_TRUST", "PAYMENT_NOT_AUTHORIZED", "PAYMENT_LINE_FULL",
     "PAYMENT_NO_ISSUER"])
PaymentResult = _simple_result("PaymentResult", PaymentResultCode)

SimplePaymentResult = Struct("SimplePaymentResult", [
    ("destination", AccountID),
    ("asset", Asset),
    ("amount", Hyper),
])

_PathPaymentSuccess = Struct("PathPaymentStrictReceiveSuccess", [
    ("offers", VarArray(ClaimAtom)),
    ("last", SimplePaymentResult),
])

PathPaymentStrictReceiveResultCode = _result_enum(
    "PathPaymentStrictReceiveResultCode",
    ["PATH_PAYMENT_STRICT_RECEIVE_SUCCESS"],
    ["PATH_PAYMENT_STRICT_RECEIVE_MALFORMED",
     "PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED",
     "PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST",
     "PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED",
     "PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION",
     "PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST",
     "PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED",
     "PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL",
     "PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER",
     "PATH_PAYMENT_STRICT_RECEIVE_TOO_FEW_OFFERS",
     "PATH_PAYMENT_STRICT_RECEIVE_OFFER_CROSS_SELF",
     "PATH_PAYMENT_STRICT_RECEIVE_OVER_SENDMAX"])
PathPaymentStrictReceiveResult = _simple_result(
    "PathPaymentStrictReceiveResult", PathPaymentStrictReceiveResultCode,
    {0: ("success", _PathPaymentSuccess),
     -9: ("noIssuer", Asset)})

_PathPaymentSendSuccess = Struct("PathPaymentStrictSendSuccess", [
    ("offers", VarArray(ClaimAtom)),
    ("last", SimplePaymentResult),
])

PathPaymentStrictSendResultCode = _result_enum(
    "PathPaymentStrictSendResultCode",
    ["PATH_PAYMENT_STRICT_SEND_SUCCESS"],
    ["PATH_PAYMENT_STRICT_SEND_MALFORMED",
     "PATH_PAYMENT_STRICT_SEND_UNDERFUNDED",
     "PATH_PAYMENT_STRICT_SEND_SRC_NO_TRUST",
     "PATH_PAYMENT_STRICT_SEND_SRC_NOT_AUTHORIZED",
     "PATH_PAYMENT_STRICT_SEND_NO_DESTINATION",
     "PATH_PAYMENT_STRICT_SEND_NO_TRUST",
     "PATH_PAYMENT_STRICT_SEND_NOT_AUTHORIZED",
     "PATH_PAYMENT_STRICT_SEND_LINE_FULL",
     "PATH_PAYMENT_STRICT_SEND_NO_ISSUER",
     "PATH_PAYMENT_STRICT_SEND_TOO_FEW_OFFERS",
     "PATH_PAYMENT_STRICT_SEND_OFFER_CROSS_SELF",
     "PATH_PAYMENT_STRICT_SEND_UNDER_DESTMIN"])
PathPaymentStrictSendResult = _simple_result(
    "PathPaymentStrictSendResult", PathPaymentStrictSendResultCode,
    {0: ("success", _PathPaymentSendSuccess),
     -9: ("noIssuer", Asset)})

ManageSellOfferResultCode = _result_enum(
    "ManageSellOfferResultCode",
    ["MANAGE_SELL_OFFER_SUCCESS"],
    ["MANAGE_SELL_OFFER_MALFORMED", "MANAGE_SELL_OFFER_SELL_NO_TRUST",
     "MANAGE_SELL_OFFER_BUY_NO_TRUST",
     "MANAGE_SELL_OFFER_SELL_NOT_AUTHORIZED",
     "MANAGE_SELL_OFFER_BUY_NOT_AUTHORIZED", "MANAGE_SELL_OFFER_LINE_FULL",
     "MANAGE_SELL_OFFER_UNDERFUNDED", "MANAGE_SELL_OFFER_CROSS_SELF",
     "MANAGE_SELL_OFFER_SELL_NO_ISSUER", "MANAGE_SELL_OFFER_BUY_NO_ISSUER",
     "MANAGE_SELL_OFFER_NOT_FOUND", "MANAGE_SELL_OFFER_LOW_RESERVE"])

ManageOfferEffect = Enum("ManageOfferEffect", {
    "MANAGE_OFFER_CREATED": 0,
    "MANAGE_OFFER_UPDATED": 1,
    "MANAGE_OFFER_DELETED": 2,
})

ManageOfferSuccessResult = Struct("ManageOfferSuccessResult", [
    ("offersClaimed", VarArray(ClaimAtom)),
    ("offer", Union("ManageOfferSuccessResultOffer", ManageOfferEffect, {
        ManageOfferEffect.MANAGE_OFFER_CREATED: ("offer", OfferEntry),
        ManageOfferEffect.MANAGE_OFFER_UPDATED: ("offer", OfferEntry),
        ManageOfferEffect.MANAGE_OFFER_DELETED: ("deleted", None),
    })),
])

ManageSellOfferResult = _simple_result(
    "ManageSellOfferResult", ManageSellOfferResultCode,
    {0: ("success", ManageOfferSuccessResult)})

ManageBuyOfferResultCode = _result_enum(
    "ManageBuyOfferResultCode",
    ["MANAGE_BUY_OFFER_SUCCESS"],
    ["MANAGE_BUY_OFFER_MALFORMED", "MANAGE_BUY_OFFER_SELL_NO_TRUST",
     "MANAGE_BUY_OFFER_BUY_NO_TRUST", "MANAGE_BUY_OFFER_SELL_NOT_AUTHORIZED",
     "MANAGE_BUY_OFFER_BUY_NOT_AUTHORIZED", "MANAGE_BUY_OFFER_LINE_FULL",
     "MANAGE_BUY_OFFER_UNDERFUNDED", "MANAGE_BUY_OFFER_CROSS_SELF",
     "MANAGE_BUY_OFFER_SELL_NO_ISSUER", "MANAGE_BUY_OFFER_BUY_NO_ISSUER",
     "MANAGE_BUY_OFFER_NOT_FOUND", "MANAGE_BUY_OFFER_LOW_RESERVE"])
ManageBuyOfferResult = _simple_result(
    "ManageBuyOfferResult", ManageBuyOfferResultCode,
    {0: ("success", ManageOfferSuccessResult)})

SetOptionsResultCode = _result_enum(
    "SetOptionsResultCode",
    ["SET_OPTIONS_SUCCESS"],
    ["SET_OPTIONS_LOW_RESERVE", "SET_OPTIONS_TOO_MANY_SIGNERS",
     "SET_OPTIONS_BAD_FLAGS", "SET_OPTIONS_INVALID_INFLATION",
     "SET_OPTIONS_CANT_CHANGE", "SET_OPTIONS_UNKNOWN_FLAG",
     "SET_OPTIONS_THRESHOLD_OUT_OF_RANGE", "SET_OPTIONS_BAD_SIGNER",
     "SET_OPTIONS_INVALID_HOME_DOMAIN",
     "SET_OPTIONS_AUTH_REVOCABLE_REQUIRED"])
SetOptionsResult = _simple_result("SetOptionsResult", SetOptionsResultCode)

ChangeTrustResultCode = _result_enum(
    "ChangeTrustResultCode",
    ["CHANGE_TRUST_SUCCESS"],
    ["CHANGE_TRUST_MALFORMED", "CHANGE_TRUST_NO_ISSUER",
     "CHANGE_TRUST_INVALID_LIMIT", "CHANGE_TRUST_LOW_RESERVE",
     "CHANGE_TRUST_SELF_NOT_ALLOWED", "CHANGE_TRUST_TRUST_LINE_MISSING",
     "CHANGE_TRUST_CANNOT_DELETE",
     "CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES"])
ChangeTrustResult = _simple_result("ChangeTrustResult", ChangeTrustResultCode)

AllowTrustResultCode = _result_enum(
    "AllowTrustResultCode",
    ["ALLOW_TRUST_SUCCESS"],
    ["ALLOW_TRUST_MALFORMED", "ALLOW_TRUST_NO_TRUST_LINE",
     "ALLOW_TRUST_TRUST_NOT_REQUIRED", "ALLOW_TRUST_CANT_REVOKE",
     "ALLOW_TRUST_SELF_NOT_ALLOWED", "ALLOW_TRUST_LOW_RESERVE"])
AllowTrustResult = _simple_result("AllowTrustResult", AllowTrustResultCode)

AccountMergeResultCode = _result_enum(
    "AccountMergeResultCode",
    ["ACCOUNT_MERGE_SUCCESS"],
    ["ACCOUNT_MERGE_MALFORMED", "ACCOUNT_MERGE_NO_ACCOUNT",
     "ACCOUNT_MERGE_IMMUTABLE_SET", "ACCOUNT_MERGE_HAS_SUB_ENTRIES",
     "ACCOUNT_MERGE_SEQNUM_TOO_FAR", "ACCOUNT_MERGE_DEST_FULL",
     "ACCOUNT_MERGE_IS_SPONSOR"])
AccountMergeResult = _simple_result(
    "AccountMergeResult", AccountMergeResultCode,
    {0: ("sourceAccountBalance", Hyper)})

InflationResultCode = _result_enum(
    "InflationResultCode", ["INFLATION_SUCCESS"], ["INFLATION_NOT_TIME"])

InflationPayout = Struct("InflationPayout", [
    ("destination", AccountID),
    ("amount", Hyper),
])

InflationResult = _simple_result(
    "InflationResult", InflationResultCode,
    {0: ("payouts", VarArray(InflationPayout))})

ManageDataResultCode = _result_enum(
    "ManageDataResultCode",
    ["MANAGE_DATA_SUCCESS"],
    ["MANAGE_DATA_NOT_SUPPORTED_YET", "MANAGE_DATA_NAME_NOT_FOUND",
     "MANAGE_DATA_LOW_RESERVE", "MANAGE_DATA_INVALID_NAME"])
ManageDataResult = _simple_result("ManageDataResult", ManageDataResultCode)

BumpSequenceResultCode = _result_enum(
    "BumpSequenceResultCode",
    ["BUMP_SEQUENCE_SUCCESS"], ["BUMP_SEQUENCE_BAD_SEQ"])
BumpSequenceResult = _simple_result(
    "BumpSequenceResult", BumpSequenceResultCode)

CreateClaimableBalanceResultCode = _result_enum(
    "CreateClaimableBalanceResultCode",
    ["CREATE_CLAIMABLE_BALANCE_SUCCESS"],
    ["CREATE_CLAIMABLE_BALANCE_MALFORMED",
     "CREATE_CLAIMABLE_BALANCE_LOW_RESERVE",
     "CREATE_CLAIMABLE_BALANCE_NO_TRUST",
     "CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED",
     "CREATE_CLAIMABLE_BALANCE_UNDERFUNDED"])
CreateClaimableBalanceResult = _simple_result(
    "CreateClaimableBalanceResult", CreateClaimableBalanceResultCode,
    {0: ("balanceID", ClaimableBalanceID)})

ClaimClaimableBalanceResultCode = _result_enum(
    "ClaimClaimableBalanceResultCode",
    ["CLAIM_CLAIMABLE_BALANCE_SUCCESS"],
    ["CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST",
     "CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM",
     "CLAIM_CLAIMABLE_BALANCE_LINE_FULL",
     "CLAIM_CLAIMABLE_BALANCE_NO_TRUST",
     "CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED"])
ClaimClaimableBalanceResult = _simple_result(
    "ClaimClaimableBalanceResult", ClaimClaimableBalanceResultCode)

BeginSponsoringFutureReservesResultCode = _result_enum(
    "BeginSponsoringFutureReservesResultCode",
    ["BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS"],
    ["BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED",
     "BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED",
     "BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE"])
BeginSponsoringFutureReservesResult = _simple_result(
    "BeginSponsoringFutureReservesResult",
    BeginSponsoringFutureReservesResultCode)

EndSponsoringFutureReservesResultCode = _result_enum(
    "EndSponsoringFutureReservesResultCode",
    ["END_SPONSORING_FUTURE_RESERVES_SUCCESS"],
    ["END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED"])
EndSponsoringFutureReservesResult = _simple_result(
    "EndSponsoringFutureReservesResult",
    EndSponsoringFutureReservesResultCode)

RevokeSponsorshipResultCode = _result_enum(
    "RevokeSponsorshipResultCode",
    ["REVOKE_SPONSORSHIP_SUCCESS"],
    ["REVOKE_SPONSORSHIP_DOES_NOT_EXIST", "REVOKE_SPONSORSHIP_NOT_SPONSOR",
     "REVOKE_SPONSORSHIP_LOW_RESERVE",
     "REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE", "REVOKE_SPONSORSHIP_MALFORMED"])
RevokeSponsorshipResult = _simple_result(
    "RevokeSponsorshipResult", RevokeSponsorshipResultCode)

ClawbackResultCode = _result_enum(
    "ClawbackResultCode",
    ["CLAWBACK_SUCCESS"],
    ["CLAWBACK_MALFORMED", "CLAWBACK_NOT_CLAWBACK_ENABLED",
     "CLAWBACK_NO_TRUST", "CLAWBACK_UNDERFUNDED"])
ClawbackResult = _simple_result("ClawbackResult", ClawbackResultCode)

ClawbackClaimableBalanceResultCode = _result_enum(
    "ClawbackClaimableBalanceResultCode",
    ["CLAWBACK_CLAIMABLE_BALANCE_SUCCESS"],
    ["CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST",
     "CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER",
     "CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED"])
ClawbackClaimableBalanceResult = _simple_result(
    "ClawbackClaimableBalanceResult", ClawbackClaimableBalanceResultCode)

SetTrustLineFlagsResultCode = _result_enum(
    "SetTrustLineFlagsResultCode",
    ["SET_TRUST_LINE_FLAGS_SUCCESS"],
    ["SET_TRUST_LINE_FLAGS_MALFORMED",
     "SET_TRUST_LINE_FLAGS_NO_TRUST_LINE",
     "SET_TRUST_LINE_FLAGS_CANT_REVOKE",
     "SET_TRUST_LINE_FLAGS_INVALID_STATE",
     "SET_TRUST_LINE_FLAGS_LOW_RESERVE"])
SetTrustLineFlagsResult = _simple_result(
    "SetTrustLineFlagsResult", SetTrustLineFlagsResultCode)

LiquidityPoolDepositResultCode = _result_enum(
    "LiquidityPoolDepositResultCode",
    ["LIQUIDITY_POOL_DEPOSIT_SUCCESS"],
    ["LIQUIDITY_POOL_DEPOSIT_MALFORMED", "LIQUIDITY_POOL_DEPOSIT_NO_TRUST",
     "LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED",
     "LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED",
     "LIQUIDITY_POOL_DEPOSIT_LINE_FULL", "LIQUIDITY_POOL_DEPOSIT_BAD_PRICE",
     "LIQUIDITY_POOL_DEPOSIT_POOL_FULL"])
LiquidityPoolDepositResult = _simple_result(
    "LiquidityPoolDepositResult", LiquidityPoolDepositResultCode)

LiquidityPoolWithdrawResultCode = _result_enum(
    "LiquidityPoolWithdrawResultCode",
    ["LIQUIDITY_POOL_WITHDRAW_SUCCESS"],
    ["LIQUIDITY_POOL_WITHDRAW_MALFORMED",
     "LIQUIDITY_POOL_WITHDRAW_NO_TRUST",
     "LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED",
     "LIQUIDITY_POOL_WITHDRAW_LINE_FULL",
     "LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM"])
LiquidityPoolWithdrawResult = _simple_result(
    "LiquidityPoolWithdrawResult", LiquidityPoolWithdrawResultCode)

OperationResultCode = Enum("OperationResultCode", {
    "opINNER": 0,
    "opBAD_AUTH": -1,
    "opNO_ACCOUNT": -2,
    "opNOT_SUPPORTED": -3,
    "opTOO_MANY_SUBENTRIES": -4,
    "opEXCEEDED_WORK_LIMIT": -5,
    "opTOO_MANY_SPONSORING": -6,
})

OperationResultTr = Union("OperationResultTr", OperationType, {
    OperationType.CREATE_ACCOUNT:
        ("createAccountResult", CreateAccountResult),
    OperationType.PAYMENT: ("paymentResult", PaymentResult),
    OperationType.PATH_PAYMENT_STRICT_RECEIVE:
        ("pathPaymentStrictReceiveResult", PathPaymentStrictReceiveResult),
    OperationType.MANAGE_SELL_OFFER:
        ("manageSellOfferResult", ManageSellOfferResult),
    OperationType.CREATE_PASSIVE_SELL_OFFER:
        ("createPassiveSellOfferResult", ManageSellOfferResult),
    OperationType.SET_OPTIONS: ("setOptionsResult", SetOptionsResult),
    OperationType.CHANGE_TRUST: ("changeTrustResult", ChangeTrustResult),
    OperationType.ALLOW_TRUST: ("allowTrustResult", AllowTrustResult),
    OperationType.ACCOUNT_MERGE: ("accountMergeResult", AccountMergeResult),
    OperationType.INFLATION: ("inflationResult", InflationResult),
    OperationType.MANAGE_DATA: ("manageDataResult", ManageDataResult),
    OperationType.BUMP_SEQUENCE: ("bumpSeqResult", BumpSequenceResult),
    OperationType.MANAGE_BUY_OFFER:
        ("manageBuyOfferResult", ManageBuyOfferResult),
    OperationType.PATH_PAYMENT_STRICT_SEND:
        ("pathPaymentStrictSendResult", PathPaymentStrictSendResult),
    OperationType.CREATE_CLAIMABLE_BALANCE:
        ("createClaimableBalanceResult", CreateClaimableBalanceResult),
    OperationType.CLAIM_CLAIMABLE_BALANCE:
        ("claimClaimableBalanceResult", ClaimClaimableBalanceResult),
    OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
        ("beginSponsoringFutureReservesResult",
         BeginSponsoringFutureReservesResult),
    OperationType.END_SPONSORING_FUTURE_RESERVES:
        ("endSponsoringFutureReservesResult",
         EndSponsoringFutureReservesResult),
    OperationType.REVOKE_SPONSORSHIP:
        ("revokeSponsorshipResult", RevokeSponsorshipResult),
    OperationType.CLAWBACK: ("clawbackResult", ClawbackResult),
    OperationType.CLAWBACK_CLAIMABLE_BALANCE:
        ("clawbackClaimableBalanceResult", ClawbackClaimableBalanceResult),
    OperationType.SET_TRUST_LINE_FLAGS:
        ("setTrustLineFlagsResult", SetTrustLineFlagsResult),
    OperationType.LIQUIDITY_POOL_DEPOSIT:
        ("liquidityPoolDepositResult", LiquidityPoolDepositResult),
    OperationType.LIQUIDITY_POOL_WITHDRAW:
        ("liquidityPoolWithdrawResult", LiquidityPoolWithdrawResult),
})

OperationResult = Union("OperationResult", OperationResultCode, {
    OperationResultCode.opINNER: ("tr", OperationResultTr),
    OperationResultCode.opBAD_AUTH: ("opBAD_AUTH", None),
    OperationResultCode.opNO_ACCOUNT: ("opNO_ACCOUNT", None),
    OperationResultCode.opNOT_SUPPORTED: ("opNOT_SUPPORTED", None),
    OperationResultCode.opTOO_MANY_SUBENTRIES:
        ("opTOO_MANY_SUBENTRIES", None),
    OperationResultCode.opEXCEEDED_WORK_LIMIT:
        ("opEXCEEDED_WORK_LIMIT", None),
    OperationResultCode.opTOO_MANY_SPONSORING:
        ("opTOO_MANY_SPONSORING", None),
})

TransactionResultCode = Enum("TransactionResultCode", {
    "txFEE_BUMP_INNER_SUCCESS": 1,
    "txSUCCESS": 0,
    "txFAILED": -1,
    "txTOO_EARLY": -2,
    "txTOO_LATE": -3,
    "txMISSING_OPERATION": -4,
    "txBAD_SEQ": -5,
    "txBAD_AUTH": -6,
    "txINSUFFICIENT_BALANCE": -7,
    "txNO_ACCOUNT": -8,
    "txINSUFFICIENT_FEE": -9,
    "txBAD_AUTH_EXTRA": -10,
    "txINTERNAL_ERROR": -11,
    "txNOT_SUPPORTED": -12,
    "txFEE_BUMP_INNER_FAILED": -13,
    "txBAD_SPONSORSHIP": -14,
    "txBAD_MIN_SEQ_AGE_OR_GAP": -15,
    "txMALFORMED": -16,
})

# txFEE_BUMP_INNER_SUCCESS / txFEE_BUMP_INNER_FAILED are NOT valid inside an
# inner result — enumerate the void arms instead of a catch-all default so
# decode rejects them like the reference's generated codec.
_inner_tx_arms = {
    TransactionResultCode.txSUCCESS: ("results", VarArray(OperationResult)),
    TransactionResultCode.txFAILED: ("results", VarArray(OperationResult)),
}
_inner_tx_arms.update({
    code: (name.lower(), None)
    for name, code in TransactionResultCode.by_name.items()
    if code not in (1, 0, -1, -13)
})
_InnerTxResultResult = Union(
    "InnerTransactionResultResult", TransactionResultCode, _inner_tx_arms)

InnerTransactionResult = Struct("InnerTransactionResult", [
    ("feeCharged", Hyper),
    ("result", _InnerTxResultResult),
    ("ext", Union("InnerTransactionResultExt", Int, {0: ("v0", None)})),
])

InnerTransactionResultPair = Struct("InnerTransactionResultPair", [
    ("transactionHash", Hash),
    ("result", InnerTransactionResult),
])

_TxResultResult = Union(
    "TransactionResultResult", TransactionResultCode,
    {
        TransactionResultCode.txFEE_BUMP_INNER_SUCCESS:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txFEE_BUMP_INNER_FAILED:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txSUCCESS:
            ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED:
            ("results", VarArray(OperationResult)),
    },
    default=("void", None))

TransactionResult = Struct("TransactionResult", [
    ("feeCharged", Hyper),
    ("result", _TxResultResult),
    ("ext", Union("TransactionResultExt", Int, {0: ("v0", None)})),
])

# ---------------------------------------------------------------------------
# Stellar-SCP.x
# ---------------------------------------------------------------------------

Value = VarOpaque()

SCPBallot = Struct("SCPBallot", [
    ("counter", Uint),
    ("value", Value),
])

SCPStatementType = Enum("SCPStatementType", {
    "SCP_ST_PREPARE": 0,
    "SCP_ST_CONFIRM": 1,
    "SCP_ST_EXTERNALIZE": 2,
    "SCP_ST_NOMINATE": 3,
})

SCPNomination = Struct("SCPNomination", [
    ("quorumSetHash", Hash),
    ("votes", VarArray(Value)),
    ("accepted", VarArray(Value)),
])

_SCPPrepare = Struct("SCPStatementPrepare", [
    ("quorumSetHash", Hash),
    ("ballot", SCPBallot),
    ("prepared", Option(SCPBallot)),
    ("preparedPrime", Option(SCPBallot)),
    ("nC", Uint),
    ("nH", Uint),
])

_SCPConfirm = Struct("SCPStatementConfirm", [
    ("ballot", SCPBallot),
    ("nPrepared", Uint),
    ("nCommit", Uint),
    ("nH", Uint),
    ("quorumSetHash", Hash),
])

_SCPExternalize = Struct("SCPStatementExternalize", [
    ("commit", SCPBallot),
    ("nH", Uint),
    ("commitQuorumSetHash", Hash),
])

SCPStatementPledges = Union("SCPStatementPledges", SCPStatementType, {
    SCPStatementType.SCP_ST_PREPARE: ("prepare", _SCPPrepare),
    SCPStatementType.SCP_ST_CONFIRM: ("confirm", _SCPConfirm),
    SCPStatementType.SCP_ST_EXTERNALIZE: ("externalize", _SCPExternalize),
    SCPStatementType.SCP_ST_NOMINATE: ("nominate", SCPNomination),
})

SCPStatement = Struct("SCPStatement", [
    ("nodeID", NodeID),
    ("slotIndex", Uhyper),
    ("pledges", SCPStatementPledges),
])

SCPEnvelope = Struct("SCPEnvelope", [
    ("statement", SCPStatement),
    ("signature", Signature),
])
# statements/envelopes re-encode constantly on the flood path (MAC per
# peer send, floodgate dedup id, signature body at every receiving
# node); both are construct-once values — the single post-construction
# mutation site (HerderSCPDriver.sign_envelope setting .signature)
# drops the envelope memo explicitly
SCPStatement.memoize = True
SCPEnvelope.memoize = True

SCPQuorumSet = Struct("SCPQuorumSet", [
    ("threshold", Uint),
    ("validators", VarArray(NodeID)),
    ("innerSets", VarArray(Lazy(lambda: SCPQuorumSet))),
])

# ---------------------------------------------------------------------------
# Stellar-ledger.x
# ---------------------------------------------------------------------------

UpgradeType = VarOpaque(128)

StellarValueType = Enum("StellarValueType", {
    "STELLAR_VALUE_BASIC": 0,
    "STELLAR_VALUE_SIGNED": 1,
})

LedgerCloseValueSignature = Struct("LedgerCloseValueSignature", [
    ("nodeID", NodeID),
    ("signature", Signature),
])

StellarValue = Struct("StellarValue", [
    ("txSetHash", Hash),
    ("closeTime", Uhyper),
    ("upgrades", VarArray(UpgradeType, 6)),
    ("ext", Union("StellarValueExt", StellarValueType, {
        StellarValueType.STELLAR_VALUE_BASIC: ("basic", None),
        StellarValueType.STELLAR_VALUE_SIGNED:
            ("lcValueSignature", LedgerCloseValueSignature),
    })),
])

MASK_LEDGER_HEADER_FLAGS = 0x7

LedgerHeaderFlags = Enum("LedgerHeaderFlags", {
    "DISABLE_LIQUIDITY_POOL_TRADING_FLAG": 0x1,
    "DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG": 0x2,
    "DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG": 0x4,
})

LedgerHeaderExtensionV1 = Struct("LedgerHeaderExtensionV1", [
    ("flags", Uint),
    ("ext", Union("LedgerHeaderExtensionV1Ext", Int, {0: ("v0", None)})),
])

LedgerHeader = Struct("LedgerHeader", [
    ("ledgerVersion", Uint),
    ("previousLedgerHash", Hash),
    ("scpValue", StellarValue),
    ("txSetResultHash", Hash),
    ("bucketListHash", Hash),
    ("ledgerSeq", Uint),
    ("totalCoins", Hyper),
    ("feePool", Hyper),
    ("inflationSeq", Uint),
    ("idPool", Uhyper),
    ("baseFee", Uint),
    ("baseReserve", Uint),
    ("maxTxSetSize", Uint),
    ("skipList", FixedArray(Hash, 4)),
    ("ext", Union("LedgerHeaderExt", Int, {
        0: ("v0", None),
        1: ("v1", LedgerHeaderExtensionV1),
    })),
])

LedgerUpgradeType = Enum("LedgerUpgradeType", {
    "LEDGER_UPGRADE_VERSION": 1,
    "LEDGER_UPGRADE_BASE_FEE": 2,
    "LEDGER_UPGRADE_MAX_TX_SET_SIZE": 3,
    "LEDGER_UPGRADE_BASE_RESERVE": 4,
    "LEDGER_UPGRADE_FLAGS": 5,
})

LedgerUpgrade = Union("LedgerUpgrade", LedgerUpgradeType, {
    LedgerUpgradeType.LEDGER_UPGRADE_VERSION: ("newLedgerVersion", Uint),
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: ("newBaseFee", Uint),
    LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
        ("newMaxTxSetSize", Uint),
    LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE: ("newBaseReserve", Uint),
    LedgerUpgradeType.LEDGER_UPGRADE_FLAGS: ("newFlags", Uint),
})

BucketEntryType = Enum("BucketEntryType", {
    "METAENTRY": -1,
    "LIVEENTRY": 0,
    "DEADENTRY": 1,
    "INITENTRY": 2,
})

BucketMetadata = Struct("BucketMetadata", [
    ("ledgerVersion", Uint),
    ("ext", Union("BucketMetadataExt", Int, {0: ("v0", None)})),
])

BucketEntry = Union("BucketEntry", BucketEntryType, {
    BucketEntryType.LIVEENTRY: ("liveEntry", LedgerEntry),
    BucketEntryType.INITENTRY: ("liveEntry", LedgerEntry),
    BucketEntryType.DEADENTRY: ("deadEntry", LedgerKey),
    BucketEntryType.METAENTRY: ("metaEntry", BucketMetadata),
})

TxSetComponentType = Enum("TxSetComponentType", {
    "TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE": 0,
})

_TxsMaybeDiscountedFee = Struct("TxsMaybeDiscountedFee", [
    ("baseFee", Option(Hyper)),
    ("txs", VarArray(TransactionEnvelope)),
])

TxSetComponent = Union("TxSetComponent", TxSetComponentType, {
    TxSetComponentType.TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE:
        ("txsMaybeDiscountedFee", _TxsMaybeDiscountedFee),
})

TransactionPhase = Union("TransactionPhase", Int, {
    0: ("v0Components", VarArray(TxSetComponent)),
})

TransactionSet = Struct("TransactionSet", [
    ("previousLedgerHash", Hash),
    ("txs", VarArray(TransactionEnvelope)),
])

TransactionSetV1 = Struct("TransactionSetV1", [
    ("previousLedgerHash", Hash),
    ("phases", VarArray(TransactionPhase)),
])

GeneralizedTransactionSet = Union("GeneralizedTransactionSet", Int, {
    1: ("v1TxSet", TransactionSetV1),
})

TransactionResultPair = Struct("TransactionResultPair", [
    ("transactionHash", Hash),
    ("result", TransactionResult),
])

TransactionResultSet = Struct("TransactionResultSet", [
    ("results", VarArray(TransactionResultPair)),
])

TransactionHistoryEntry = Struct("TransactionHistoryEntry", [
    ("ledgerSeq", Uint),
    ("txSet", TransactionSet),
    ("ext", Union("TransactionHistoryEntryExt", Int, {
        0: ("v0", None),
        1: ("generalizedTxSet", GeneralizedTransactionSet),
    })),
])

TransactionHistoryResultEntry = Struct("TransactionHistoryResultEntry", [
    ("ledgerSeq", Uint),
    ("txResultSet", TransactionResultSet),
    ("ext", Union("TransactionHistoryResultEntryExt", Int,
                  {0: ("v0", None)})),
])

LedgerHeaderHistoryEntry = Struct("LedgerHeaderHistoryEntry", [
    ("hash", Hash),
    ("header", LedgerHeader),
    ("ext", Union("LedgerHeaderHistoryEntryExt", Int, {0: ("v0", None)})),
])

LedgerSCPMessages = Struct("LedgerSCPMessages", [
    ("ledgerSeq", Uint),
    ("messages", VarArray(SCPEnvelope)),
])

SCPHistoryEntryV0 = Struct("SCPHistoryEntryV0", [
    ("quorumSets", VarArray(SCPQuorumSet)),
    ("ledgerMessages", LedgerSCPMessages),
])

SCPHistoryEntry = Union("SCPHistoryEntry", Int, {
    0: ("v0", SCPHistoryEntryV0),
})

LedgerEntryChangeType = Enum("LedgerEntryChangeType", {
    "LEDGER_ENTRY_CREATED": 0,
    "LEDGER_ENTRY_UPDATED": 1,
    "LEDGER_ENTRY_REMOVED": 2,
    "LEDGER_ENTRY_STATE": 3,
})

LedgerEntryChange = Union("LedgerEntryChange", LedgerEntryChangeType, {
    LedgerEntryChangeType.LEDGER_ENTRY_CREATED: ("created", LedgerEntry),
    LedgerEntryChangeType.LEDGER_ENTRY_UPDATED: ("updated", LedgerEntry),
    LedgerEntryChangeType.LEDGER_ENTRY_REMOVED: ("removed", LedgerKey),
    LedgerEntryChangeType.LEDGER_ENTRY_STATE: ("state", LedgerEntry),
})

LedgerEntryChanges = VarArray(LedgerEntryChange)

OperationMeta = Struct("OperationMeta", [
    ("changes", LedgerEntryChanges),
])

TransactionMetaV1 = Struct("TransactionMetaV1", [
    ("txChanges", LedgerEntryChanges),
    ("operations", VarArray(OperationMeta)),
])

TransactionMetaV2 = Struct("TransactionMetaV2", [
    ("txChangesBefore", LedgerEntryChanges),
    ("operations", VarArray(OperationMeta)),
    ("txChangesAfter", LedgerEntryChanges),
])

TransactionMeta = Union("TransactionMeta", Int, {
    0: ("operations", VarArray(OperationMeta)),
    1: ("v1", TransactionMetaV1),
    2: ("v2", TransactionMetaV2),
})

TransactionResultMeta = Struct("TransactionResultMeta", [
    ("result", TransactionResultPair),
    ("feeProcessing", LedgerEntryChanges),
    ("txApplyProcessing", TransactionMeta),
])

UpgradeEntryMeta = Struct("UpgradeEntryMeta", [
    ("upgrade", LedgerUpgrade),
    ("changes", LedgerEntryChanges),
])

LedgerCloseMetaV0 = Struct("LedgerCloseMetaV0", [
    ("ledgerHeader", LedgerHeaderHistoryEntry),
    ("txSet", TransactionSet),
    ("txProcessing", VarArray(TransactionResultMeta)),
    ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
    ("scpInfo", VarArray(SCPHistoryEntry)),
])

LedgerCloseMetaV1 = Struct("LedgerCloseMetaV1", [
    ("ledgerHeader", LedgerHeaderHistoryEntry),
    ("txSet", GeneralizedTransactionSet),
    ("txProcessing", VarArray(TransactionResultMeta)),
    ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
    ("scpInfo", VarArray(SCPHistoryEntry)),
])

LedgerCloseMeta = Union("LedgerCloseMeta", Int, {
    0: ("v0", LedgerCloseMetaV0),
    1: ("v1", LedgerCloseMetaV1),
})

# results + metas are encoded 2-3x per close (result-set hash, txhistory
# row, ledger-close meta stream) — cache the first encoding on the value
TransactionResultPair.memoize = True
TransactionMeta.memoize = True
# the batched fee kernel returns feeProcessing changes pre-encoded; the
# memo slot lets LazyUnion carry those bytes straight into the meta
LedgerEntryChange.memoize = True

# route encode() through the native schema-VM packer when the toolchain
# can build it (native/xdr_pack.c); wire-identical, Python pack remains
# the oracle and fallback
import sys as _sys

from .runtime import enable_native_encode as _enable_native_encode

# import stays cheap: only an already-built extension is used here; node
# startup (Application.start) retries with build=True and flips this on
NATIVE_ENCODE = _enable_native_encode(_sys.modules[__name__], build=False)


def ensure_native_encode() -> bool:
    """Build + enable the native encoder (idempotent; called from
    Application.start so every node process gets it)."""
    global NATIVE_ENCODE
    if not NATIVE_ENCODE:
        NATIVE_ENCODE = _enable_native_encode(
            _sys.modules[__name__], build=True)
    return NATIVE_ENCODE
