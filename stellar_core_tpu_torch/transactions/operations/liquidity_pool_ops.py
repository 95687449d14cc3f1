"""LiquidityPoolDeposit / LiquidityPoolWithdraw op frames
(ref src/transactions/{LiquidityPoolDepositOpFrame,
LiquidityPoolWithdrawOpFrame}.cpp)."""
from __future__ import annotations

from ...xdr import types as T
from .. import liquidity_pool as LP
from .. import utils as U
from .base import OperationFrame, op_inner, put_account, put_trustline

OT = T.OperationType
INT64_MAX = U.INT64_MAX


class LiquidityPoolDepositOpFrame(OperationFrame):
    TYPE = OT.LIQUIDITY_POOL_DEPOSIT
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.LiquidityPoolDepositResult.make(code))

    def do_check_valid(self, header):
        C = T.LiquidityPoolDepositResultCode
        b = self.body
        if b.maxAmountA <= 0 or b.maxAmountB <= 0:
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
        for pr in (b.minPrice, b.maxPrice):
            if pr.n <= 0 or pr.d <= 0:
                return self._res(C.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
        if b.minPrice.n * b.maxPrice.d > b.minPrice.d * b.maxPrice.n:
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
        return None

    def _available(self, ltx, header, asset, src_id):
        """(available_balance, trustline_entry_or_None, authorized)."""
        if U.is_native(asset):
            acc = ltx.load_account(src_id).data.value
            return U.get_available_balance(header, acc), None, True
        tl_entry = ltx.load_trustline(src_id, asset)
        if tl_entry is None:
            return None, None, False
        tl = tl_entry.data.value
        return (U.trustline_available_balance(tl), tl_entry,
                U.is_authorized(tl))

    def _debit(self, ltx, header, asset, src_id, amount):
        if U.is_native(asset):
            entry = ltx.load_account(src_id)
            put_account(ltx, entry,
                        U.add_balance(entry.data.value, -amount))
        else:
            entry = ltx.load_trustline(src_id, asset)
            tl = entry.data.value
            put_trustline(ltx, entry,
                          tl._replace(balance=tl.balance - amount))

    def do_apply(self, ltx):
        C = T.LiquidityPoolDepositResultCode
        header = ltx.header()
        src_id = self.source_account_id()
        b = self.body
        pool_id = b.liquidityPoolID

        tl_pool_entry = LP.load_pool_share_trustline(ltx, src_id, pool_id)
        if tl_pool_entry is None:
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_NO_TRUST)
        pool_entry = LP.load_pool(ltx, pool_id)
        if pool_entry is None:
            raise RuntimeError("pool share trustline without pool")
        cp = LP.constant_product(pool_entry)

        avail_a, _, auth_a = self._available(ltx, header, cp.params.assetA,
                                             src_id)
        avail_b, _, auth_b = self._available(ltx, header, cp.params.assetB,
                                             src_id)
        if avail_a is None or avail_b is None:
            raise RuntimeError("pool asset trustline missing")
        if not (auth_a and auth_b):
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED)

        tl_pool = tl_pool_entry.data.value
        avail_limit = U.trustline_max_receive(tl_pool)

        if cp.totalPoolShares != 0:
            sh_a = LP.big_divide(cp.totalPoolShares, b.maxAmountA,
                                 cp.reserveA, LP.ROUND_DOWN)
            sh_b = LP.big_divide(cp.totalPoolShares, b.maxAmountB,
                                 cp.reserveB, LP.ROUND_DOWN)
            cands = [s for s in (sh_a, sh_b) if s is not None]
            if not cands:
                raise RuntimeError("both share calculations overflowed")
            shares = min(cands)
            amount_a = LP.big_divide(shares, cp.reserveA,
                                     cp.totalPoolShares, LP.ROUND_UP)
            amount_b = LP.big_divide(shares, cp.reserveB,
                                     cp.totalPoolShares, LP.ROUND_UP)
            if amount_a is None or amount_b is None:
                raise RuntimeError("deposit amount overflowed")
        else:
            amount_a, amount_b = b.maxAmountA, b.maxAmountB
            shares = LP.big_square_root(amount_a, amount_b)

        if avail_a < amount_a or avail_b < amount_b:
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED)
        # price check: amountA/amountB within [minPrice, maxPrice]
        if (amount_a == 0 or amount_b == 0
                or amount_a * b.minPrice.d < amount_b * b.minPrice.n
                or amount_a * b.maxPrice.d > amount_b * b.maxPrice.n):
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
        if avail_limit < shares:
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_LINE_FULL)
        if (INT64_MAX - amount_a < cp.reserveA
                or INT64_MAX - amount_b < cp.reserveB
                or INT64_MAX - shares < cp.totalPoolShares):
            return self._res(C.LIQUIDITY_POOL_DEPOSIT_POOL_FULL)
        if amount_a <= 0 or amount_b <= 0 or shares <= 0:
            raise RuntimeError("non-positive deposit")

        self._debit(ltx, header, cp.params.assetA, src_id, amount_a)
        self._debit(ltx, header, cp.params.assetB, src_id, amount_b)
        tl_pool_entry = LP.load_pool_share_trustline(ltx, src_id, pool_id)
        tl_pool = tl_pool_entry.data.value
        put_trustline(ltx, tl_pool_entry,
                      tl_pool._replace(balance=tl_pool.balance + shares))
        cp = cp._replace(reserveA=cp.reserveA + amount_a,
                         reserveB=cp.reserveB + amount_b,
                         totalPoolShares=cp.totalPoolShares + shares)
        ltx.put(LP.pool_with_cp(pool_entry, cp))
        return self._res(C.LIQUIDITY_POOL_DEPOSIT_SUCCESS)


class LiquidityPoolWithdrawOpFrame(OperationFrame):
    TYPE = OT.LIQUIDITY_POOL_WITHDRAW
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.LiquidityPoolWithdrawResult.make(code))

    def do_check_valid(self, header):
        C = T.LiquidityPoolWithdrawResultCode
        b = self.body
        if b.amount <= 0 or b.minAmountA < 0 or b.minAmountB < 0:
            return self._res(C.LIQUIDITY_POOL_WITHDRAW_MALFORMED)
        return None

    def _credit(self, ltx, header, asset, src_id, min_amount, amount):
        """Returns an error result or None (ref tryAddAssetBalance)."""
        C = T.LiquidityPoolWithdrawResultCode
        if amount < min_amount:
            return self._res(C.LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM)
        if U.is_native(asset):
            entry = ltx.load_account(src_id)
            acc = entry.data.value
            if U.get_max_receive(header, acc) < amount:
                return self._res(C.LIQUIDITY_POOL_WITHDRAW_LINE_FULL)
            put_account(ltx, entry, U.add_balance(acc, amount))
        else:
            entry = ltx.load_trustline(src_id, asset)
            if entry is None:
                raise RuntimeError("pool asset trustline missing")
            tl = entry.data.value
            # authorized-to-maintain-liabilities suffices for withdraw
            if not U.is_authorized_to_maintain_liabilities(tl):
                return self._res(C.LIQUIDITY_POOL_WITHDRAW_NO_TRUST)
            if U.trustline_max_receive(tl) < amount:
                return self._res(C.LIQUIDITY_POOL_WITHDRAW_LINE_FULL)
            put_trustline(ltx, entry,
                          tl._replace(balance=tl.balance + amount))
        return None

    def do_apply(self, ltx):
        C = T.LiquidityPoolWithdrawResultCode
        header = ltx.header()
        src_id = self.source_account_id()
        b = self.body
        pool_id = b.liquidityPoolID

        tl_pool_entry = LP.load_pool_share_trustline(ltx, src_id, pool_id)
        if tl_pool_entry is None:
            return self._res(C.LIQUIDITY_POOL_WITHDRAW_NO_TRUST)
        tl_pool = tl_pool_entry.data.value
        if U.trustline_available_balance(tl_pool) < b.amount:
            return self._res(C.LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED)
        pool_entry = LP.load_pool(ltx, pool_id)
        if pool_entry is None:
            raise RuntimeError("pool share trustline without pool")
        cp = LP.constant_product(pool_entry)

        amount_a = LP.get_pool_withdrawal_amount(
            b.amount, cp.totalPoolShares, cp.reserveA)
        err = self._credit(ltx, header, cp.params.assetA, src_id,
                           b.minAmountA, amount_a)
        if err is not None:
            return err
        amount_b = LP.get_pool_withdrawal_amount(
            b.amount, cp.totalPoolShares, cp.reserveB)
        err = self._credit(ltx, header, cp.params.assetB, src_id,
                           b.minAmountB, amount_b)
        if err is not None:
            return err

        tl_pool_entry = LP.load_pool_share_trustline(ltx, src_id, pool_id)
        tl_pool = tl_pool_entry.data.value
        put_trustline(ltx, tl_pool_entry,
                      tl_pool._replace(balance=tl_pool.balance - b.amount))
        cp = cp._replace(reserveA=cp.reserveA - amount_a,
                         reserveB=cp.reserveB - amount_b,
                         totalPoolShares=cp.totalPoolShares - b.amount)
        ltx.put(LP.pool_with_cp(pool_entry, cp))
        return self._res(C.LIQUIDITY_POOL_WITHDRAW_SUCCESS)
