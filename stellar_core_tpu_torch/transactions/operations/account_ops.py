"""BumpSequence, ManageData, SetOptions, ChangeTrust, AllowTrust,
SetTrustLineFlags, Clawback op frames
(ref src/transactions/{BumpSequenceOpFrame,ManageDataOpFrame,
SetOptionsOpFrame,ChangeTrustOpFrame,AllowTrustOpFrame,
SetTrustLineFlagsOpFrame,ClawbackOpFrame}.cpp)."""
from __future__ import annotations

from ...crypto import sha256
from ...ledger.ledger_txn import entry_to_key
from ...xdr import types as T
from .. import utils as U
from .base import OperationFrame, op_inner, put_account, put_trustline


def _revoke_asset_holdings(op_frame, ltx, trustor_id: bytes, asset) -> None:
    """Full auth revocation side effects: pull the trustor's offers in the
    asset and redeem pool-share trustlines using it into claimable
    balances (ref removeOffersAndPoolShareTrustLines)."""
    from .. import liquidity_pool as LP
    from ..offer_exchange import remove_offers_by_account_and_asset

    remove_offers_by_account_and_asset(ltx, trustor_id, asset)

    def balance_id_for(pool_id: bytes, withdrawn_asset) -> bytes:
        # sha256(HashIDPreimage POOL_REVOKE_OP_ID) (ref CAP-38 revoke IDs)
        et = T.EnvelopeType.ENVELOPE_TYPE_POOL_REVOKE_OP_ID
        pre = T.HashIDPreimage.make(et, T.HashIDPreimage.arms[et][1].make(
            sourceAccount=T.account_id(op_frame.tx.source_account_id()),
            seqNum=op_frame.tx.seq_num(),
            opNum=op_frame.tx.op_frames.index(op_frame),
            liquidityPoolID=pool_id,
            asset=withdrawn_asset))
        return sha256(T.HashIDPreimage.encode(pre))

    LP.redeem_pool_share_trustlines(ltx, trustor_id, asset, balance_id_for)

OT = T.OperationType
INT64_MAX = U.INT64_MAX

_put_account = put_account
_put_trustline = put_trustline


class BumpSequenceOpFrame(OperationFrame):
    TYPE = OT.BUMP_SEQUENCE
    THRESHOLD = U.ThresholdLevel.LOW

    def _res(self, code):
        return op_inner(self.TYPE, T.BumpSequenceResult.make(code))

    def do_check_valid(self, header):
        C = T.BumpSequenceResultCode
        if self.body.bumpTo < 0:
            return self._res(C.BUMP_SEQUENCE_BAD_SEQ)
        return None

    def do_apply(self, ltx):
        C = T.BumpSequenceResultCode
        header = ltx.header()
        entry = self.load_source_account(ltx)
        acc = entry.data.value
        # bump succeeds silently when bumpTo <= current; at v19 the
        # seqLedger/seqTime stamp is written (and shows up in the meta)
        # even for a no-op backward jump (ref BumpSequenceOpFrame.cpp:46-63)
        new_seq = max(acc.seqNum, self.body.bumpTo)
        acc = U.set_seq_info(acc, new_seq, header.ledgerSeq,
                             header.scpValue.closeTime)
        _put_account(ltx, entry, acc)
        return self._res(C.BUMP_SEQUENCE_SUCCESS)


class ManageDataOpFrame(OperationFrame):
    TYPE = OT.MANAGE_DATA
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.ManageDataResult.make(code))

    def do_check_valid(self, header):
        C = T.ManageDataResultCode
        name = self.body.dataName
        if not name or len(name) > 64:
            return self._res(C.MANAGE_DATA_INVALID_NAME)
        try:
            name.decode("ascii")
        except UnicodeDecodeError:
            return self._res(C.MANAGE_DATA_INVALID_NAME)
        return None

    def do_apply(self, ltx):
        C = T.ManageDataResultCode
        header = ltx.header()
        src_id = self.source_account_id()
        acc_entry = self.load_source_account(ltx)
        acc = acc_entry.data.value
        existing = ltx.load_data(src_id, self.body.dataName)

        from .. import sponsorship as SP
        from .base import op_error

        if self.body.dataValue is None:
            # delete
            if existing is None:
                return self._res(C.MANAGE_DATA_NAME_NOT_FOUND)
            SP.remove_entry_with_possible_sponsorship(ltx, existing, src_id)
            ltx.erase(entry_to_key(existing))
            return self._res(C.MANAGE_DATA_SUCCESS)

        if existing is None:
            de = T.DataEntry.make(
                accountID=T.account_id(src_id),
                dataName=self.body.dataName,
                dataValue=self.body.dataValue,
                ext=T.DataEntry.fields[3][1].make(0))
            new_entry = U.wrap_entry(T.LedgerEntryType.DATA, de)
            res, new_entry = SP.create_entry_with_possible_sponsorship(
                ltx, new_entry, src_id, owner_entry=acc_entry)
            err = SP.map_sponsorship_result(
                res, self._res(C.MANAGE_DATA_LOW_RESERVE))
            if err is not None:
                return err
            ltx.put(new_entry)
        else:
            de = existing.data.value._replace(dataValue=self.body.dataValue)
            ltx.put(existing._replace(
                data=T.LedgerEntryData.make(T.LedgerEntryType.DATA, de)))
        return self._res(C.MANAGE_DATA_SUCCESS)


class SetOptionsOpFrame(OperationFrame):
    TYPE = OT.SET_OPTIONS

    def _res(self, code):
        return op_inner(self.TYPE, T.SetOptionsResult.make(code))

    def threshold_level(self):
        b = self.body
        if (b.masterWeight is not None or b.lowThreshold is not None
                or b.medThreshold is not None or b.highThreshold is not None
                or b.signer is not None):
            return U.ThresholdLevel.HIGH
        return U.ThresholdLevel.MEDIUM

    def do_check_valid(self, header):
        C = T.SetOptionsResultCode
        b = self.body
        if b.setFlags is not None and b.clearFlags is not None:
            if b.setFlags & b.clearFlags:
                return self._res(C.SET_OPTIONS_BAD_FLAGS)
        for v in (b.masterWeight, b.lowThreshold, b.medThreshold,
                  b.highThreshold):
            if v is not None and v > 255:
                return self._res(C.SET_OPTIONS_THRESHOLD_OUT_OF_RANGE)
        allowed = T.MASK_ACCOUNT_FLAGS_V17
        for v in (b.setFlags, b.clearFlags):
            if v is not None and v & ~allowed:
                return self._res(C.SET_OPTIONS_UNKNOWN_FLAG)
        if b.homeDomain is not None:
            try:
                b.homeDomain.decode("ascii")
            except UnicodeDecodeError:
                return self._res(C.SET_OPTIONS_INVALID_HOME_DOMAIN)
        if b.signer is not None:
            if b.signer.key.value == self.source_account_id() and \
                    b.signer.key.type == \
                    T.SignerKeyType.SIGNER_KEY_TYPE_ED25519:
                return self._res(C.SET_OPTIONS_BAD_SIGNER)
        return None

    def do_apply(self, ltx):
        C = T.SetOptionsResultCode
        header = ltx.header()
        b = self.body
        entry = self.load_source_account(ltx)
        acc = entry.data.value

        if b.inflationDest is not None:
            if ltx.load_account(b.inflationDest.value) is None:
                return self._res(C.SET_OPTIONS_INVALID_INFLATION)
            acc = acc._replace(inflationDest=b.inflationDest)

        flags = acc.flags
        if b.clearFlags is not None:
            if flags & T.AUTH_IMMUTABLE_FLAG and \
                    b.clearFlags & T.MASK_ACCOUNT_FLAGS:
                return self._res(C.SET_OPTIONS_CANT_CHANGE)
            flags &= ~b.clearFlags
        if b.setFlags is not None:
            if acc.flags & T.AUTH_IMMUTABLE_FLAG and \
                    b.setFlags & T.MASK_ACCOUNT_FLAGS:
                return self._res(C.SET_OPTIONS_CANT_CHANGE)
            flags |= b.setFlags
        # AUTH_REVOCABLE required for clawback
        if flags & T.AUTH_CLAWBACK_ENABLED_FLAG and \
                not flags & T.AUTH_REVOCABLE_FLAG:
            return self._res(C.SET_OPTIONS_AUTH_REVOCABLE_REQUIRED)
        acc = acc._replace(flags=flags)

        th = bytearray(acc.thresholds)
        if b.masterWeight is not None:
            th[0] = b.masterWeight
        if b.lowThreshold is not None:
            th[1] = b.lowThreshold
        if b.medThreshold is not None:
            th[2] = b.medThreshold
        if b.highThreshold is not None:
            th[3] = b.highThreshold
        acc = acc._replace(thresholds=bytes(th))

        if b.homeDomain is not None:
            acc = acc._replace(homeDomain=b.homeDomain)

        if b.signer is not None:
            from .. import sponsorship as SP
            from .base import op_error

            signers = list(acc.signers)
            sids = SP.signer_sponsoring_ids(acc)
            skey_b = T.SignerKey.encode(b.signer.key)
            idx = next(
                (i for i, s in enumerate(signers)
                 if T.SignerKey.encode(s.key) == skey_b), None)
            if b.signer.weight == 0:
                if idx is None:
                    return self._res(C.SET_OPTIONS_BAD_SIGNER)
                old_sponsor = sids[idx].value if sids[idx] is not None \
                    else None
                # the sponsor is always a different account (begin-
                # sponsoring's recursion rules forbid self-sponsorship)
                SP.release_signer_sponsorship(ltx, old_sponsor)
                if old_sponsor is not None:
                    acc = SP.add_num_sponsored(acc, -1)
                signers.pop(idx)
                sids.pop(idx)
                acc = acc._replace(numSubEntries=acc.numSubEntries - 1)
            elif idx is not None:
                signers[idx] = b.signer
            else:
                if len(signers) >= T.MAX_SIGNERS:
                    return self._res(C.SET_OPTIONS_TOO_MANY_SIGNERS)
                res, sponsor_id = SP.create_signer_with_possible_sponsorship(
                    ltx, entry, self.source_account_id())
                err = SP.map_sponsorship_result(
                    res, self._res(C.SET_OPTIONS_LOW_RESERVE))
                if err is not None:
                    return err
                acc = acc._replace(numSubEntries=acc.numSubEntries + 1)
                if sponsor_id is not None:
                    acc = SP.add_num_sponsored(acc, 1)
                signers.append(b.signer)
                sids.append(T.account_id(sponsor_id)
                            if sponsor_id is not None else None)
            order = sorted(range(len(signers)),
                           key=lambda i: T.SignerKey.encode(signers[i].key))
            signers = [signers[i] for i in order]
            sids = [sids[i] for i in order]
            acc = acc._replace(signers=signers)
            if any(s is not None for s in sids) or (
                    acc.ext.type == 1 and acc.ext.value.ext.type == 2):
                acc = SP.set_signer_sponsoring_ids(acc, sids)

        _put_account(ltx, entry, acc)
        return self._res(C.SET_OPTIONS_SUCCESS)


class ChangeTrustOpFrame(OperationFrame):
    TYPE = OT.CHANGE_TRUST
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.ChangeTrustResult.make(code))

    def _is_pool(self) -> bool:
        return self.body.line.type == T.AssetType.ASSET_TYPE_POOL_SHARE

    def do_check_valid(self, header):
        C = T.ChangeTrustResultCode
        from .. import liquidity_pool as LP

        line = self.body.line
        if self.body.limit < 0:
            return self._res(C.CHANGE_TRUST_MALFORMED)
        if line.type == T.AssetType.ASSET_TYPE_NATIVE:
            return self._res(C.CHANGE_TRUST_MALFORMED)
        if line.type == T.AssetType.ASSET_TYPE_POOL_SHARE:
            cp = line.value.value  # ConstantProduct params
            for a in (cp.assetA, cp.assetB):
                if not U.is_asset_valid(a):
                    return self._res(C.CHANGE_TRUST_MALFORMED)
                if U.asset_issuer(a) == self.source_account_id():
                    return self._res(C.CHANGE_TRUST_SELF_NOT_ALLOWED)
            if LP.compare_assets(cp.assetA, cp.assetB) >= 0:
                return self._res(C.CHANGE_TRUST_MALFORMED)
            if cp.fee != T.LIQUIDITY_POOL_FEE_V18:
                return self._res(C.CHANGE_TRUST_MALFORMED)
            return None
        asset = T.Asset.make(line.type, line.value)
        if not U.is_asset_valid(asset):
            return self._res(C.CHANGE_TRUST_MALFORMED)
        if U.asset_issuer(asset) == self.source_account_id():
            return self._res(C.CHANGE_TRUST_SELF_NOT_ALLOWED)
        return None

    def _tl_asset(self):
        from .. import liquidity_pool as LP

        line = self.body.line
        if self._is_pool():
            pool_id = LP.pool_id_from_params(line.value)
            return T.TrustLineAsset.make(
                T.AssetType.ASSET_TYPE_POOL_SHARE, pool_id)
        return T.TrustLineAsset.make(line.type, line.value)

    def _load_tl(self, ltx, src_id):
        arm = T.LedgerKey.arms[T.LedgerEntryType.TRUSTLINE][1].make(
            accountID=T.account_id(src_id), asset=self._tl_asset())
        return ltx.load(T.LedgerKey.make(T.LedgerEntryType.TRUSTLINE, arm))

    def _inc_pool_use(self, ltx, asset, src_id):
        """ref tryIncrementPoolUseCount: underlying-asset trustline must
        exist + maintain-liabilities auth; bump its use count."""
        from .. import liquidity_pool as LP
        C = T.ChangeTrustResultCode

        if U.is_native(asset) or U.asset_issuer(asset) == src_id:
            return None
        tl_entry = ltx.load_trustline(src_id, asset)
        if tl_entry is None:
            return self._res(C.CHANGE_TRUST_TRUST_LINE_MISSING)
        tl = tl_entry.data.value
        if not U.is_authorized_to_maintain_liabilities(tl):
            return self._res(C.CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES)
        _put_trustline(ltx, tl_entry, LP.tl_with_pool_use_delta(tl, 1))
        return None

    def _dec_pool_use(self, ltx, asset, src_id):
        from .. import liquidity_pool as LP

        if U.is_native(asset) or U.asset_issuer(asset) == src_id:
            return
        tl_entry = ltx.load_trustline(src_id, asset)
        if tl_entry is not None:
            _put_trustline(ltx, tl_entry,
                           LP.tl_with_pool_use_delta(tl_entry.data.value, -1))

    def do_apply(self, ltx):
        C = T.ChangeTrustResultCode
        from .. import liquidity_pool as LP
        from .. import sponsorship as SP

        src_id = self.source_account_id()
        line = self.body.line
        limit = self.body.limit
        is_pool = self._is_pool()
        tl_entry = self._load_tl(ltx, src_id)

        if tl_entry is not None:
            tl = tl_entry.data.value
            buying, _ = U.trustline_liabilities(tl)
            if limit != 0 and limit < tl.balance + buying:
                return self._res(C.CHANGE_TRUST_INVALID_LIMIT)
            if limit == 0:
                if tl.balance != 0:
                    return self._res(C.CHANGE_TRUST_INVALID_LIMIT)
                bl, sl = U.trustline_liabilities(tl)
                if bl or sl:
                    return self._res(C.CHANGE_TRUST_CANNOT_DELETE)
                if not is_pool and LP.tl_pool_use_count(tl) != 0:
                    return self._res(C.CHANGE_TRUST_CANNOT_DELETE)
                SP.remove_entry_with_possible_sponsorship(
                    ltx, tl_entry, src_id)
                ltx.erase(entry_to_key(tl_entry))
                if is_pool:
                    cp_params = line.value.value
                    self._dec_pool_use(ltx, cp_params.assetA, src_id)
                    self._dec_pool_use(ltx, cp_params.assetB, src_id)
                    pool_id = LP.pool_id_from_params(line.value)
                    pool_entry = LP.load_pool(ltx, pool_id)
                    if pool_entry is None:
                        raise RuntimeError("liquidity pool is missing")
                    cp = LP.constant_product(pool_entry)
                    cp = cp._replace(
                        poolSharesTrustLineCount=cp
                        .poolSharesTrustLineCount - 1)
                    if cp.poolSharesTrustLineCount == 0:
                        ltx.erase(entry_to_key(pool_entry))
                    else:
                        ltx.put(LP.pool_with_cp(pool_entry, cp))
                return self._res(C.CHANGE_TRUST_SUCCESS)
            if not is_pool and ltx.load_account(
                    U.asset_issuer(T.Asset.make(line.type,
                                                line.value))) is None:
                return self._res(C.CHANGE_TRUST_NO_ISSUER)
            _put_trustline(ltx, tl_entry,
                           tl_entry.data.value._replace(limit=limit))
            return self._res(C.CHANGE_TRUST_SUCCESS)

        # new trustline
        if limit == 0:
            return self._res(C.CHANGE_TRUST_INVALID_LIMIT)
        flags = 0
        if not is_pool:
            asset = T.Asset.make(line.type, line.value)
            issuer_entry = ltx.load_account(U.asset_issuer(asset))
            if issuer_entry is None:
                return self._res(C.CHANGE_TRUST_NO_ISSUER)
            issuer = issuer_entry.data.value
            if not issuer.flags & T.AUTH_REQUIRED_FLAG:
                flags |= T.AUTHORIZED_FLAG
            if issuer.flags & T.AUTH_CLAWBACK_ENABLED_FLAG:
                flags |= T.TRUSTLINE_CLAWBACK_ENABLED_FLAG
        else:
            cp_params = line.value.value
            err = self._inc_pool_use(ltx, cp_params.assetA, src_id)
            if err is not None:
                return err
            err = self._inc_pool_use(ltx, cp_params.assetB, src_id)
            if err is not None:
                return err
            pool_id = LP.pool_id_from_params(line.value)
            pool_entry = LP.load_pool(ltx, pool_id)
            if pool_entry is not None:
                cp = LP.constant_product(pool_entry)
                cp = cp._replace(
                    poolSharesTrustLineCount=cp.poolSharesTrustLineCount + 1)
                ltx.put(LP.pool_with_cp(pool_entry, cp))
            else:
                cp = T.LiquidityPoolEntry.fields[1][1].arms[
                    T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT][
                    1].make(params=cp_params, reserveA=0, reserveB=0,
                            totalPoolShares=0, poolSharesTrustLineCount=1)
                lp = T.LiquidityPoolEntry.make(
                    liquidityPoolID=pool_id,
                    body=T.LiquidityPoolEntry.fields[1][1].make(
                        T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
                        cp))
                ltx.put(U.wrap_entry(T.LedgerEntryType.LIQUIDITY_POOL, lp))

        tl = T.TrustLineEntry.make(
            accountID=T.account_id(src_id),
            asset=self._tl_asset(),
            balance=0, limit=limit, flags=flags,
            ext=T.TrustLineEntry.fields[5][1].make(0))
        new_entry = U.wrap_entry(T.LedgerEntryType.TRUSTLINE, tl)
        res, new_entry = SP.create_entry_with_possible_sponsorship(
            ltx, new_entry, src_id)
        err = SP.map_sponsorship_result(
            res, self._res(C.CHANGE_TRUST_LOW_RESERVE))
        if err is not None:
            return err
        ltx.put(new_entry)
        return self._res(C.CHANGE_TRUST_SUCCESS)


class AllowTrustOpFrame(OperationFrame):
    TYPE = OT.ALLOW_TRUST
    THRESHOLD = U.ThresholdLevel.LOW

    def _res(self, code):
        return op_inner(self.TYPE, T.AllowTrustResult.make(code))

    def do_check_valid(self, header):
        """ref AllowTrustOpFrame::doCheckValid — all failures MALFORMED at
        protocol 19 (authorize must be 0, AUTHORIZED_FLAG, or
        AUTHORIZED_TO_MAINTAIN alone; both flags together invalid at v13+;
        self-allow MALFORMED at v16+, replacing SELF_NOT_ALLOWED)."""
        C = T.AllowTrustResultCode
        b = self.body
        if b.asset.type == T.AssetType.ASSET_TYPE_NATIVE:
            return self._res(C.ALLOW_TRUST_MALFORMED)
        if b.authorize > T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG:
            return self._res(C.ALLOW_TRUST_MALFORMED)
        if b.asset.type == T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            full = U.asset_alphanum4(b.asset.value,
                                     self.source_account_id())
        else:
            full = U.asset_alphanum12(b.asset.value,
                                      self.source_account_id())
        if not U.is_asset_valid(full):
            return self._res(C.ALLOW_TRUST_MALFORMED)
        if b.trustor.value == self.source_account_id():
            return self._res(C.ALLOW_TRUST_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.AllowTrustResultCode
        src_id = self.source_account_id()
        issuer_entry = self.load_source_account(ltx)
        issuer = issuer_entry.data.value
        if not issuer.flags & T.AUTH_REQUIRED_FLAG:
            return self._res(C.ALLOW_TRUST_TRUST_NOT_REQUIRED)
        # build the full asset with self as issuer
        if self.body.asset.type == T.AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            asset = U.asset_alphanum4(self.body.asset.value, src_id)
        else:
            asset = U.asset_alphanum12(self.body.asset.value, src_id)
        tl_entry = ltx.load_trustline(self.body.trustor.value, asset)
        if tl_entry is None:
            return self._res(C.ALLOW_TRUST_NO_TRUST_LINE)
        tl = tl_entry.data.value
        mask = (T.AUTHORIZED_FLAG
                | T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
        cur = tl.flags & mask
        new = self.body.authorize
        # any downgrade of auth requires AUTH_REVOCABLE
        downgrade = (
            (cur & T.AUTHORIZED_FLAG and new != T.AUTHORIZED_FLAG)
            or (cur & T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG
                and new == 0))
        if downgrade and not issuer.flags & T.AUTH_REVOCABLE_FLAG:
            return self._res(C.ALLOW_TRUST_CANT_REVOKE)
        if new == 0 and cur != 0:
            _revoke_asset_holdings(self, ltx, self.body.trustor.value,
                                   asset)
            tl_entry = ltx.load_trustline(self.body.trustor.value, asset)
            tl = tl_entry.data.value
        tl = tl._replace(flags=(tl.flags & ~mask) | new)
        _put_trustline(ltx, tl_entry, tl)
        return self._res(C.ALLOW_TRUST_SUCCESS)


class SetTrustLineFlagsOpFrame(OperationFrame):
    TYPE = OT.SET_TRUST_LINE_FLAGS
    THRESHOLD = U.ThresholdLevel.LOW

    def _res(self, code):
        return op_inner(self.TYPE, T.SetTrustLineFlagsResult.make(code))

    def do_check_valid(self, header):
        C = T.SetTrustLineFlagsResultCode
        b = self.body
        if b.trustor.value == self.source_account_id():
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if not U.is_asset_valid(b.asset) or U.is_native(b.asset):
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if U.asset_issuer(b.asset) != self.source_account_id():
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.setFlags & b.clearFlags:
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        allowed = T.MASK_TRUSTLINE_FLAGS_V17
        if b.setFlags & ~allowed or b.clearFlags & ~allowed:
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        if b.setFlags & T.TRUSTLINE_CLAWBACK_ENABLED_FLAG:
            return self._res(C.SET_TRUST_LINE_FLAGS_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.SetTrustLineFlagsResultCode
        issuer_entry = self.load_source_account(ltx)
        issuer = issuer_entry.data.value
        b = self.body
        revoking = bool(b.clearFlags & (
            T.AUTHORIZED_FLAG
            | T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG))
        if revoking and not issuer.flags & T.AUTH_REVOCABLE_FLAG:
            return self._res(C.SET_TRUST_LINE_FLAGS_CANT_REVOKE)
        tl_entry = ltx.load_trustline(b.trustor.value, b.asset)
        if tl_entry is None:
            return self._res(C.SET_TRUST_LINE_FLAGS_NO_TRUST_LINE)
        tl = tl_entry.data.value
        flags = (tl.flags & ~b.clearFlags) | b.setFlags
        # invalid state: both AUTHORIZED and MAINTAIN_LIABILITIES
        if (flags & T.AUTHORIZED_FLAG
                and flags & T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self._res(C.SET_TRUST_LINE_FLAGS_INVALID_STATE)
        auth_mask = (T.AUTHORIZED_FLAG
                     | T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
        if (tl.flags & auth_mask) and not (flags & auth_mask):
            _revoke_asset_holdings(self, ltx, b.trustor.value, b.asset)
            tl_entry = ltx.load_trustline(b.trustor.value, b.asset)
            tl = tl_entry.data.value
        tl = tl._replace(flags=flags)
        _put_trustline(ltx, tl_entry, tl)
        return self._res(C.SET_TRUST_LINE_FLAGS_SUCCESS)


class ClawbackOpFrame(OperationFrame):
    TYPE = OT.CLAWBACK
    THRESHOLD = U.ThresholdLevel.MEDIUM

    def _res(self, code):
        return op_inner(self.TYPE, T.ClawbackResult.make(code))

    def do_check_valid(self, header):
        C = T.ClawbackResultCode
        b = self.body
        if b.amount <= 0:
            return self._res(C.CLAWBACK_MALFORMED)
        if not U.is_asset_valid(b.asset) or U.is_native(b.asset):
            return self._res(C.CLAWBACK_MALFORMED)
        if U.asset_issuer(b.asset) != self.source_account_id():
            return self._res(C.CLAWBACK_MALFORMED)
        return None

    def do_apply(self, ltx):
        C = T.ClawbackResultCode
        b = self.body
        from_id = U.muxed_to_account_id(b.from_)
        tl_entry = ltx.load_trustline(from_id, b.asset)
        if tl_entry is None:
            return self._res(C.CLAWBACK_NO_TRUST)
        tl = tl_entry.data.value
        if not U.is_clawback_enabled_tl(tl):
            return self._res(C.CLAWBACK_NOT_CLAWBACK_ENABLED)
        if U.trustline_available_balance(tl) < b.amount:
            return self._res(C.CLAWBACK_UNDERFUNDED)
        tl = tl._replace(balance=tl.balance - b.amount)
        _put_trustline(ltx, tl_entry, tl)
        return self._res(C.CLAWBACK_SUCCESS)


class InflationOpFrame(OperationFrame):
    TYPE = OT.INFLATION
    THRESHOLD = U.ThresholdLevel.LOW

    def _res(self, code, payouts=None):
        return op_inner(self.TYPE, T.InflationResult.make(
            code, payouts if code == 0 else None))

    def is_supported(self, header) -> bool:
        # ref InflationOpFrame::isOpSupported: protocol < 12 only
        return header.ledgerVersion < 12

    def do_apply(self, ltx):
        return self._res(T.InflationResultCode.INFLATION_NOT_TIME)
