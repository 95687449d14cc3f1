"""Operation frames: one class per OperationType
(ref src/transactions/*OpFrame.cpp — SURVEY.md §2.5)."""
from __future__ import annotations

from ...xdr import types as T
from .account_ops import (  # noqa: F401
    AllowTrustOpFrame, BumpSequenceOpFrame, ChangeTrustOpFrame,
    ClawbackOpFrame, InflationOpFrame, ManageDataOpFrame, SetOptionsOpFrame,
    SetTrustLineFlagsOpFrame,
)
from .base import OperationFrame, op_error, op_inner  # noqa: F401
from .claimable_balance import (  # noqa: F401
    ClaimClaimableBalanceOpFrame, ClawbackClaimableBalanceOpFrame,
    CreateClaimableBalanceOpFrame,
)
from .liquidity_pool_ops import (  # noqa: F401
    LiquidityPoolDepositOpFrame, LiquidityPoolWithdrawOpFrame,
)
from .offers import (  # noqa: F401
    CreatePassiveSellOfferOpFrame, ManageBuyOfferOpFrame,
    ManageSellOfferOpFrame, PathPaymentStrictReceiveOpFrame,
    PathPaymentStrictSendOpFrame,
)
from .payments import (  # noqa: F401
    AccountMergeOpFrame, CreateAccountOpFrame, PaymentOpFrame,
)
from .sponsorship_ops import (  # noqa: F401
    BeginSponsoringFutureReservesOpFrame,
    EndSponsoringFutureReservesOpFrame, RevokeSponsorshipOpFrame,
)

OT = T.OperationType

_REGISTRY = {
    OT.CREATE_CLAIMABLE_BALANCE: CreateClaimableBalanceOpFrame,
    OT.CLAIM_CLAIMABLE_BALANCE: ClaimClaimableBalanceOpFrame,
    OT.CLAWBACK_CLAIMABLE_BALANCE: ClawbackClaimableBalanceOpFrame,
    OT.BEGIN_SPONSORING_FUTURE_RESERVES: BeginSponsoringFutureReservesOpFrame,
    OT.END_SPONSORING_FUTURE_RESERVES: EndSponsoringFutureReservesOpFrame,
    OT.REVOKE_SPONSORSHIP: RevokeSponsorshipOpFrame,
    OT.LIQUIDITY_POOL_DEPOSIT: LiquidityPoolDepositOpFrame,
    OT.LIQUIDITY_POOL_WITHDRAW: LiquidityPoolWithdrawOpFrame,
    OT.CREATE_ACCOUNT: CreateAccountOpFrame,
    OT.PAYMENT: PaymentOpFrame,
    OT.ACCOUNT_MERGE: AccountMergeOpFrame,
    OT.BUMP_SEQUENCE: BumpSequenceOpFrame,
    OT.MANAGE_DATA: ManageDataOpFrame,
    OT.SET_OPTIONS: SetOptionsOpFrame,
    OT.CHANGE_TRUST: ChangeTrustOpFrame,
    OT.ALLOW_TRUST: AllowTrustOpFrame,
    OT.SET_TRUST_LINE_FLAGS: SetTrustLineFlagsOpFrame,
    OT.CLAWBACK: ClawbackOpFrame,
    OT.INFLATION: InflationOpFrame,
    OT.MANAGE_SELL_OFFER: ManageSellOfferOpFrame,
    OT.MANAGE_BUY_OFFER: ManageBuyOfferOpFrame,
    OT.CREATE_PASSIVE_SELL_OFFER: CreatePassiveSellOfferOpFrame,
    OT.PATH_PAYMENT_STRICT_RECEIVE: PathPaymentStrictReceiveOpFrame,
    OT.PATH_PAYMENT_STRICT_SEND: PathPaymentStrictSendOpFrame,
}


class NotSupportedOpFrame(OperationFrame):
    """Placeholder for op types not yet implemented: fails cleanly with
    opNOT_SUPPORTED instead of crashing (coverage grows per round)."""

    def do_check_valid(self, header):
        return op_error(T.OperationResultCode.opNOT_SUPPORTED)

    def do_apply(self, ltx):
        return op_error(T.OperationResultCode.opNOT_SUPPORTED)


def make_operation_frame(op, tx) -> OperationFrame:
    cls = _REGISTRY.get(op.body.type, NotSupportedOpFrame)
    f = cls(op, tx)
    return f


def register_op(op_type: int, cls) -> None:
    _REGISTRY[op_type] = cls
