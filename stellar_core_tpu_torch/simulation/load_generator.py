"""LoadGenerator: the standard synthetic load source for benchmarks and
soak tests (ref src/simulation/LoadGenerator.h:28-36 — modes CREATE / PAY;
the reference drives it via the test-build 'generateload' HTTP endpoint).

CREATE seeds n accounts; PAY builds single-op payment transactions between
them.  Accounts are written straight into the ledger root (bulk-seeding
like the reference's createAccounts batches); payments are real signed
envelopes that flow through whatever admission path the caller uses.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..crypto import SecretKey, sha256
from ..ledger.ledger_txn import LedgerTxn
from ..transactions import utils as U
from ..transactions.signature_checker import signature_hint
from ..xdr import types as T

CREATE = "create"
PAY = "pay"

# rate mode: generation quantum (seconds of virtual/real clock per tick)
RATE_TICK_SECONDS = 1.0


class LoadGenerator:
    def __init__(self, app):
        self.app = app
        self.network_id = app.config.network_id()
        self.accounts: List[SecretKey] = []
        self._seqs = {}
        self._rate_timer = None
        self._rate_state: Optional[dict] = None
        # payment destination graph: "ring" (i pays i+1; one conflict
        # component), "pairs" (2j <-> 2j+1; disjoint account pairs),
        # "credit" (pairs graph, but payments move the LOAD credit
        # asset over trustlines — setup_dex() first), or "pool" (pairs
        # graph, path payments routed through LIVE constant-product
        # pools — setup_pool() first)
        self.payment_pattern = "ring"

    # -- deterministic account derivation -----------------------------------

    @staticmethod
    def account_key(i: int, prefix: bytes = b"loadgen") -> SecretKey:
        """The i-th generator account key, derived purely from the index
        (ref LoadGenerator::findAccount — accounts are a deterministic
        function of their ordinal, so a restarted node can regenerate
        load against accounts created before the restart without
        re-creating them)."""
        return SecretKey(sha256(prefix + b"-%d" % i))

    def restore_accounts(self, prefix: bytes = b"loadgen",
                         limit: int = 100_000) -> int:
        """Rebuild the account pool after a process restart by probing the
        ledger for consecutively-derived accounts until one is absent.
        Returns how many accounts were recovered."""
        from ..ledger.ledger_txn import entry_to_key, key_bytes

        root = self.app.ledger_manager.root
        found = []
        for i in range(limit):
            sk = self.account_key(i, prefix)
            kb = key_bytes(entry_to_key(
                U.make_account_entry(sk.public_key().raw, 0)))
            if root.get(kb) is None:
                break
            found.append(sk)
        self.accounts = found
        self._seqs = {}
        return len(found)

    # -- CREATE mode --------------------------------------------------------

    def create_accounts(self, n: int, balance: int = 10**9,
                        prefix: bytes = b"loadgen") -> List[SecretKey]:
        """Seed n funded accounts directly into the ledger root (bulk;
        the per-tx path would be n CreateAccount ops)."""
        root = self.app.ledger_manager.root
        new = [self.account_key(i, prefix) for i in range(n)]
        with LedgerTxn(root) as ltx:
            for sk in new:
                ltx.put(U.make_account_entry(
                    sk.public_key().raw, balance, seq_num=0))
            ltx.commit()
        self.accounts.extend(new)
        return new

    # -- PAY mode -----------------------------------------------------------

    def _next_seq(self, sk: SecretKey) -> int:
        k = sk.public_key().raw
        if k not in self._seqs:
            root = self.app.ledger_manager.root
            with LedgerTxn(root) as ltx:
                e = ltx.load_account(k)
                ltx.rollback()
            if e is None:
                # account not on-ledger yet (e.g. a seeding stage called
                # before its close): the envelope will be rejected at
                # admission — do NOT cache, or the eventual real seqnum
                # (ledgerSeq<<32) would never be read and every retry
                # would be a sequence gap
                return 1
            self._seqs[k] = e.data.value.seqNum
        self._seqs[k] += 1
        return self._seqs[k]

    def payment_envelope(self, src: SecretKey, dest: bytes, amount: int,
                         fee: int = 100, asset=None):
        op = T.Operation.make(
            sourceAccount=None,
            body=T.OperationBody.make(
                T.OperationType.PAYMENT,
                T.PaymentOp.make(destination=T.muxed_account(dest),
                                 asset=asset if asset is not None
                                 else U.asset_native(),
                                 amount=amount)))
        return self._sign_tx(src, [op], fee)

    def _payment_dest(self, accts: List[SecretKey], i: int,
                      dest_accounts: Optional[List[SecretKey]] = None
                      ) -> bytes:
        """Destination for payment i: ``ring`` (each account pays its
        successor — one fully-connected conflict component, the
        parallel-apply worst case) or ``pairs`` (2j <-> 2j+1 — disjoint
        account pairs, the independent-users shape real traffic
        approximates and conflict clustering can spread).

        ``dest_accounts``: draw destinations from a DIFFERENT pool than
        the sources (payment i -> dest_accounts[i]) — the recipients-
        aren't-senders shape, where admission never pre-warms the
        destination entries and the close's prefetch does real work."""
        if dest_accounts is not None:
            return dest_accounts[i % len(dest_accounts)].public_key().raw
        k = len(accts)
        if self.payment_pattern in ("pairs", "credit"):
            j = i % k
            p = j ^ 1
            if p >= k:
                p = j  # odd pool tail: self-payment, still pair-local
            return accts[p].public_key().raw
        return accts[(i + 1) % k].public_key().raw

    def generate_payments(self, n: int,
                          accounts: Optional[List[SecretKey]] = None,
                          dest_accounts: Optional[List[SecretKey]] = None
                          ) -> List:
        """n one-op payments round-robin across the account pool
        (destination graph per ``payment_pattern``; sequence numbers
        tracked per source)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        if self.payment_pattern == "pool":
            assert getattr(self, "pool_ids", None), \
                "setup_pool() first for payment_pattern='pool'"
            return self.generate_pool_payments(n, accounts=accounts)
        asset = None
        if self.payment_pattern == "credit":
            assert getattr(self, "dex_asset", None) is not None, \
                "setup_dex() first for payment_pattern='credit'"
            asset = self.dex_asset
        out = []
        k = len(accts)
        for i in range(n):
            src = accts[i % k]
            dest = self._payment_dest(accts, i, dest_accounts)
            out.append(self.payment_envelope(src, dest, 1 + (i % 1000),
                                             asset=asset))
        return out

    # -- PRETEND mode -------------------------------------------------------

    def pretend_envelope(self, src: SecretKey, op_count: int = 1,
                         fee: int = 100):
        """SetOptions no-op-shaped txs sized like real traffic (ref
        LoadGenerator::pretendTransaction :721 — inflationDest=self,
        16-char homeDomain, first op padded with an extra signer)."""
        pub = src.public_key().raw
        ops = []
        for i in range(op_count):
            home = b"*" * (24 if i == 0 else 16)
            signer = None
            if i == 0:
                signer = T.Signer.make(
                    key=T.SignerKey.make(
                        T.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                        bytes(32)),
                    weight=0)  # weight 0 = delete-if-present no-op
            ops.append(T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.SET_OPTIONS,
                    T.SetOptionsOp.make(
                        inflationDest=T.account_id(pub),
                        clearFlags=None, setFlags=None,
                        masterWeight=None, lowThreshold=None,
                        medThreshold=None, highThreshold=None,
                        homeDomain=home, signer=signer))))
        return self._sign_tx(src, ops, fee * max(1, op_count))

    def generate_pretend(self, n: int, op_count: int = 1,
                         accounts: Optional[List[SecretKey]] = None
                         ) -> List:
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        return [self.pretend_envelope(accts[i % len(accts)], op_count)
                for i in range(n)]

    # -- MIXED_TXS mode -----------------------------------------------------

    def _derive_dex(self) -> None:
        """One derivation for both seeding paths (bulk setup_dex and the
        staged HTTP envelopes) so they can never diverge."""
        issuer = SecretKey(sha256(b"loadgen-dex-issuer"))
        self.dex_issuer = issuer
        self.dex_asset = U.make_asset(b"LOAD", issuer.public_key().raw)

    def setup_dex(self, accounts: Optional[List[SecretKey]] = None,
                  credit: int = 10**7) -> None:
        """Seed the DEX leg of MIXED_TXS: a LOAD-asset issuer plus a
        funded trustline for every generator account (bulk-written like
        create_accounts; the per-tx path would be changeTrust+payment)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        root = self.app.ledger_manager.root
        self._derive_dex()
        issuer = self.dex_issuer
        with LedgerTxn(root) as ltx:
            if ltx.load_account(issuer.public_key().raw) is None:
                ltx.put(U.make_account_entry(
                    issuer.public_key().raw, 10**9, seq_num=0))
            for sk in accts:
                pub = sk.public_key().raw
                if ltx.load_trustline(pub, self.dex_asset) is None:
                    ltx.put(U.make_trustline_entry(
                        pub, self.dex_asset, balance=credit,
                        limit=U.INT64_MAX))
                    e = ltx.load_account(pub)
                    acc = e.data.value
                    ltx.put(e._replace(data=T.LedgerEntryData.make(
                        T.LedgerEntryType.ACCOUNT,
                        acc._replace(
                            numSubEntries=acc.numSubEntries + 1))))
            ltx.commit()

    def offer_envelope(self, src: SecretKey, amount: int,
                       price_n: int, price_d: int, fee: int = 100,
                       selling=None, buying=None, offer_id: int = 0):
        """ManageSellOffer envelope; default shape sells native for the
        LOAD asset as a NEW offer (ref manageOfferTransaction), but any
        pair / offerID works — offer_id != 0 with amount > 0 is a
        modify, with amount == 0 a delete."""
        op = T.Operation.make(
            sourceAccount=None,
            body=T.OperationBody.make(
                T.OperationType.MANAGE_SELL_OFFER,
                T.ManageSellOfferOp.make(
                    selling=selling if selling is not None
                    else U.asset_native(),
                    buying=buying if buying is not None
                    else self.dex_asset,
                    amount=amount,
                    price=T.Price.make(n=price_n, d=price_d),
                    offerID=offer_id)))
        return self._sign_tx(src, [op], fee)

    def changetrust_envelope(self, src: SecretKey, asset,
                             limit: int = U.INT64_MAX, fee: int = 100):
        """ChangeTrust envelope over a classic asset (create when no
        line exists, limit update when one does, delete at limit=0)."""
        op = T.Operation.make(
            sourceAccount=None,
            body=T.OperationBody.make(
                T.OperationType.CHANGE_TRUST,
                T.ChangeTrustOp.make(
                    line=T.ChangeTrustAsset.make(asset.type, asset.value),
                    limit=limit)))
        return self._sign_tx(src, [op], fee)

    def generate_mixed(self, n: int, dex_percent: int = 50,
                       accounts: Optional[List[SecretKey]] = None,
                       dest_accounts: Optional[List[SecretKey]] = None
                       ) -> List:
        """Payments + DEX offers at ``dex_percent`` (ref MIXED_TXS
        :308-318; deterministic pseudo-mix instead of the reference's
        PRNG so benches are reproducible)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        assert getattr(self, "dex_asset", None) is not None, \
            "setup_dex() first"
        out = []
        k = len(accts)
        for i in range(n):
            src = accts[i % k]
            if (i * 7919 + 13) % 100 < dex_percent:
                # prices spread so offers rarely cross (book grows like
                # the reference's synthetic DEX load)
                out.append(self.offer_envelope(
                    src, 10 + i % 90, 100 + (i % 50), 100))
            else:
                dest = self._payment_dest(accts, i, dest_accounts)
                out.append(self.payment_envelope(src, dest,
                                                 1 + (i % 1000)))
        return out

    # -- CREDIT mode (ISSUE 13: credit-heavy realistic traffic) -------------

    def _derive_credit2(self) -> None:
        issuer2 = SecretKey(sha256(b"loadgen-credit-issuer2"))
        self.credit2_issuer = issuer2
        self.credit2_asset = U.make_asset(b"CRD2",
                                          issuer2.public_key().raw)

    def setup_credit(self, accounts: Optional[List[SecretKey]] = None,
                     credit: int = 10**7) -> None:
        """Seed the credit-mix workload: the LOAD issuer + funded
        trustlines (setup_dex) plus a SECOND issuer/asset (CRD2) whose
        trustlines the workload creates and resizes through real
        changeTrust transactions — the trustline create/update kernel
        surface."""
        self.setup_dex(accounts=accounts, credit=credit)
        self._derive_credit2()
        root = self.app.ledger_manager.root
        with LedgerTxn(root) as ltx:
            if ltx.load_account(self.credit2_issuer.public_key().raw) \
                    is None:
                ltx.put(U.make_account_entry(
                    self.credit2_issuer.public_key().raw, 10**9,
                    seq_num=0))
            ltx.commit()

    def create_credit_issuer_envelopes(self) -> List:
        """Stage A of TX-BASED credit-mix seeding (the HTTP
        generateload path, state-commitment-safe): create the LOAD and
        CRD2 issuers from the network root — their own close, so later
        trustlines cannot race them."""
        root = self.root_key()
        self._derive_dex()
        self._derive_credit2()
        envs = []
        for issuer in (self.dex_issuer, self.credit2_issuer):
            envs.append(self._sign_tx(root, [T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.CREATE_ACCOUNT,
                    T.CreateAccountOp.make(
                        destination=T.account_id(
                            issuer.public_key().raw),
                        startingBalance=10**9)))], 100))
        return envs

    def generate_credit_mix(self, n: int, trust_pct: int = 10,
                            accounts: Optional[List[SecretKey]] = None
                            ) -> List:
        """Credit-heavy close shape: LOAD-asset payments over disjoint
        account pairs, salted with ``trust_pct``% changeTrust ops on the
        CRD2 asset (first touch creates the line, later touches resize
        its limit) — the credit/trustline op families real Stellar
        traffic is dominated by, in conflict shapes the planner can
        spread.  Deterministic pseudo-mix like generate_mixed."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        assert getattr(self, "credit2_asset", None) is not None, \
            "setup_credit() first"
        prev_pattern = self.payment_pattern
        self.payment_pattern = "credit"
        out = []
        k = len(accts)
        try:
            for i in range(n):
                src = accts[i % k]
                if (i * 7919 + 13) % 100 < trust_pct:
                    # vary the limit so repeat touches are real updates
                    limit = U.INT64_MAX - (i % 5)
                    out.append(self.changetrust_envelope(
                        src, self.credit2_asset, limit))
                else:
                    dest = self._payment_dest(accts, i, None)
                    out.append(self.payment_envelope(
                        src, dest, 1 + (i % 1000),
                        asset=self.dex_asset))
        finally:
            self.payment_pattern = prev_pattern
        return out

    # -- PATHPAY mode (ISSUE 13: multi-hop conversion chains) ---------------

    def _derive_path(self, hops: int, makers: int):
        """Deterministic issuers/assets/makers of the ``hops``-hop
        chain (shared by the bulk seeder and the tx-based stages)."""
        assert 1 <= hops <= 3, "path workloads support 1-3 hops"
        names = [b"PATHA", b"PATHB", b"PATHC"][:hops]
        issuers = [SecretKey(sha256(b"loadgen-path-issuer-" + nm))
                   for nm in names]
        assets = [U.make_asset(nm, sk.public_key().raw)
                  for nm, sk in zip(names, issuers)]
        maker_keys = [self.account_key(j, b"pathmaker")
                      for j in range(makers)]
        self.path_issuers = issuers
        self.path_assets = assets
        self.path_makers = maker_keys
        return issuers, assets, maker_keys

    def path_stage_envelopes(self, stage: int, hops: int = 2,
                             makers: int = 8,
                             maker_credit: int = 10**12,
                             offer_amount: int = 10**10) -> List:
        """TX-BASED pathpay seeding for the HTTP generateload path —
        four stages, one ledger close between each (the returned
        envelopes must all be admitted before advancing):

        0. network root creates the hop issuers + maker accounts;
        1. trustlines: makers trust every hop asset, every generator
           account trusts the FINAL asset (the recipients);
        2. issuers fund the makers in their asset;
        3. makers post the hop offers (selling hop asset i for the
           previous chain asset, native first) — the seeded books.
        """
        issuers, assets, maker_keys = self._derive_path(hops, makers)
        root = self.root_key()
        if stage == 0:
            ops = [T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.CREATE_ACCOUNT,
                    T.CreateAccountOp.make(
                        destination=T.account_id(sk.public_key().raw),
                        startingBalance=10**9)))
                for sk in (*issuers, *maker_keys)]
            return [self._sign_tx(root, ops, 100 * len(ops))]
        if stage == 1:
            envs = []
            for mk in maker_keys:
                for asset in assets:
                    envs.append(self.changetrust_envelope(mk, asset))
            final = assets[-1]
            for sk in self.accounts:
                envs.append(self.changetrust_envelope(sk, final))
            return envs
        if stage == 2:
            envs = []
            for issuer, asset in zip(issuers, assets):
                ops = [T.Operation.make(
                    sourceAccount=None,
                    body=T.OperationBody.make(
                        T.OperationType.PAYMENT,
                        T.PaymentOp.make(
                            destination=T.muxed_account(
                                mk.public_key().raw),
                            asset=asset, amount=maker_credit)))
                    for mk in maker_keys]
                envs.append(self._sign_tx(issuer, ops, 100 * len(ops)))
            return envs
        assert stage == 3, f"unknown path stage {stage}"
        return self._maker_offer_envelopes(assets, maker_keys,
                                           offer_amount)

    def _maker_offer_envelopes(self, assets, maker_keys,
                               offer_amount: int) -> List:
        """The seeded hop books: each maker sells hop asset i for the
        previous chain asset (native first) at 1:1, deep amounts so
        thousands of small path payments shave offers without
        exhausting a book.  One builder for BOTH seeding paths (bulk
        setup_path and the tx-based HTTP stages) so the two workloads
        can never drift apart."""
        envs = []
        chain_buy = [U.asset_native(), *assets[:-1]]
        for mk in maker_keys:
            for selling, buying in zip(assets, chain_buy):
                envs.append(self.offer_envelope(
                    mk, offer_amount, 1, 1, selling=selling,
                    buying=buying))
        return envs

    def setup_path(self, hops: int = 2, makers: int = 8,
                   maker_credit: int = 10**15,
                   offer_amount: int = 10**12) -> List:
        """Seed ``hops``-hop path-payment books: one issuer+asset per
        chain step (PATHA, PATHB, PATHC...), maker accounts holding
        deep balances in every step asset, and trustlines in the FINAL
        asset for every generator account (they are the recipients).

        Seeding writes accounts/trustlines in bulk (perf-rig style,
        like setup_dex) but returns the market-maker OFFER envelopes
        for the caller to admit + close: resting offers carry
        liabilities and consume offer ids, so they must flow through
        the real close path to keep the id pool and reserve accounting
        consistent.  Chain: native -> PATHA [-> PATHB ...] -> final."""
        assert self.accounts, "CREATE accounts first"
        issuers, assets, maker_keys = self._derive_path(hops, makers)
        root = self.app.ledger_manager.root
        with LedgerTxn(root) as ltx:
            for sk in issuers:
                if ltx.load_account(sk.public_key().raw) is None:
                    ltx.put(U.make_account_entry(
                        sk.public_key().raw, 10**9, seq_num=0))
            for mk in maker_keys:
                pub = mk.public_key().raw
                if ltx.load_account(pub) is None:
                    ltx.put(U.make_account_entry(pub, 10**9, seq_num=0))
                subentries = 0
                for asset in assets:
                    if ltx.load_trustline(pub, asset) is None:
                        ltx.put(U.make_trustline_entry(
                            pub, asset, balance=maker_credit,
                            limit=U.INT64_MAX))
                        subentries += 1
                if subentries:
                    e = ltx.load_account(pub)
                    acc = e.data.value
                    ltx.put(e._replace(data=T.LedgerEntryData.make(
                        T.LedgerEntryType.ACCOUNT,
                        acc._replace(numSubEntries=acc.numSubEntries
                                     + subentries))))
            final = assets[-1]
            for sk in self.accounts:
                pub = sk.public_key().raw
                if ltx.load_trustline(pub, final) is None:
                    ltx.put(U.make_trustline_entry(
                        pub, final, balance=0, limit=U.INT64_MAX))
                    e = ltx.load_account(pub)
                    acc = e.data.value
                    ltx.put(e._replace(data=T.LedgerEntryData.make(
                        T.LedgerEntryType.ACCOUNT,
                        acc._replace(
                            numSubEntries=acc.numSubEntries + 1))))
            ltx.commit()
        return self._maker_offer_envelopes(assets, maker_keys,
                                           offer_amount)

    def path_payment_envelope(self, src: SecretKey, dest: bytes,
                              amount: int, strict_send: bool = True,
                              fee: int = 100):
        """One path payment over the seeded chain: native in, the final
        path asset out, intermediate assets as the declared path."""
        assets = self.path_assets
        path = assets[:-1]
        dest_asset = assets[-1]
        if strict_send:
            body = T.PathPaymentStrictSendOp.make(
                sendAsset=U.asset_native(), sendAmount=amount,
                destination=T.muxed_account(dest), destAsset=dest_asset,
                destMin=1, path=path)
            op_type = T.OperationType.PATH_PAYMENT_STRICT_SEND
        else:
            body = T.PathPaymentStrictReceiveOp.make(
                sendAsset=U.asset_native(), sendMax=4 * amount + 100,
                destination=T.muxed_account(dest), destAsset=dest_asset,
                destAmount=amount, path=path)
            op_type = T.OperationType.PATH_PAYMENT_STRICT_RECEIVE
        op = T.Operation.make(
            sourceAccount=None,
            body=T.OperationBody.make(op_type, body))
        return self._sign_tx(src, [op], fee)

    def generate_path_payments(self, n: int,
                               accounts: Optional[List[SecretKey]] = None
                               ) -> List:
        """n path payments over the seeded books, alternating
        strict-send / strict-receive, destinations on the disjoint
        pairs graph (sources are never makers, so self-crossing cannot
        fire)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        assert getattr(self, "path_assets", None) is not None, \
            "setup_path() first"
        out = []
        k = len(accts)
        for i in range(n):
            src = accts[i % k]
            j = i % k
            p = j ^ 1
            if p >= k:
                p = j
            dest = accts[p].public_key().raw
            out.append(self.path_payment_envelope(
                src, dest, 1 + (i % 500), strict_send=(i % 2 == 0)))
        return out

    # -- POOL mode (path payments through LIVE liquidity pools) -------------

    def setup_pool(self, hops: int = 2, reserve: int = 10**12) -> None:
        """Seed ``hops``-hop LIVE constant-product pools: one pool per
        chain hop pair (native<->PATHA [, PATHA<->PATHB ...]) with deep
        equal reserves, plus final-asset trustlines for every generator
        account (the recipients).  NO maker books: the pools are the
        only venue on each hop, so every path payment crosses them (the
        empty book walk loses the book-vs-pool arbitration and the
        constant-product quote adjudicates).  Bulk-seeded perf-rig
        style like setup_path; flips ``payment_pattern`` to "pool"."""
        from ..transactions import liquidity_pool as LP

        assert self.accounts, "CREATE accounts first"
        issuers, assets, _ = self._derive_path(hops, makers=0)
        root = self.app.ledger_manager.root
        pool_ids = []
        cp_type = T.LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT
        with LedgerTxn(root) as ltx:
            for sk in issuers:
                if ltx.load_account(sk.public_key().raw) is None:
                    ltx.put(U.make_account_entry(
                        sk.public_key().raw, 10**9, seq_num=0))
            final = assets[-1]
            for sk in self.accounts:
                pub = sk.public_key().raw
                if ltx.load_trustline(pub, final) is None:
                    ltx.put(U.make_trustline_entry(
                        pub, final, balance=0, limit=U.INT64_MAX))
                    e = ltx.load_account(pub)
                    acc = e.data.value
                    ltx.put(e._replace(data=T.LedgerEntryData.make(
                        T.LedgerEntryType.ACCOUNT,
                        acc._replace(
                            numSubEntries=acc.numSubEntries + 1))))
            chain = [U.asset_native(), *assets]
            for x, y in zip(chain, chain[1:]):
                a, b = ((x, y) if LP.compare_assets(x, y) < 0
                        else (y, x))
                params = T.LiquidityPoolParameters.make(
                    cp_type,
                    T.LiquidityPoolConstantProductParameters.make(
                        assetA=a, assetB=b,
                        fee=T.LIQUIDITY_POOL_FEE_V18))
                pool_id = LP.pool_id_from_params(params)
                cp = T.LiquidityPoolEntry.fields[1][1].arms[
                    cp_type][1].make(
                    params=params.value, reserveA=reserve,
                    reserveB=reserve, totalPoolShares=reserve,
                    poolSharesTrustLineCount=1)
                lp = T.LiquidityPoolEntry.make(
                    liquidityPoolID=pool_id,
                    body=T.LiquidityPoolEntry.fields[1][1].make(
                        cp_type, cp))
                ltx.put(U.wrap_entry(
                    T.LedgerEntryType.LIQUIDITY_POOL, lp))
                pool_ids.append(pool_id)
            ltx.commit()
        self.pool_ids = pool_ids
        self.payment_pattern = "pool"

    def generate_pool_payments(self, n: int,
                               accounts: Optional[List[SecretKey]] = None
                               ) -> List:
        """n path payments routed through the seeded pools — the same
        alternating strict-send / strict-receive mix as the book
        workload, but amounts start at 10: the 30bps constant-product
        fee must never round a hop's output to zero (a zero-output
        quote is a FAILED path payment, which the success-only kernel
        declines — poisoning its whole cluster off the fast path)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        assert getattr(self, "pool_ids", None), "setup_pool() first"
        out = []
        k = len(accts)
        for i in range(n):
            src = accts[i % k]
            j = i % k
            p = j ^ 1
            if p >= k:
                p = j
            dest = accts[p].public_key().raw
            out.append(self.path_payment_envelope(
                src, dest, 10 + (i % 500), strict_send=(i % 2 == 0)))
        return out

    # -- RATE mode (timer-driven tx/s; ref LoadGenerator.h:28-36) -----------

    def start_rate_run(self, mode: str = PAY, rate: float = 10.0,
                       duration: float = 10.0, dex_percent: int = 50,
                       op_count: int = 1) -> dict:
        """Sustain ``rate`` tx/s for ``duration`` clock-seconds (the
        reference's generateLoad txRate scheduling): a VirtualTimer ticks
        every RATE_TICK_SECONDS and ENQUEUES the generation work on the
        app's fair scheduler (utils/scheduler.py, queue "loadgen"), so
        sustained load shares the crank with consensus instead of
        preempting it — the soak shape that makes queue aging, banning
        and rebroadcast reachable.  Returns the initial status dict."""
        from ..utils.clock import VirtualTimer

        assert mode in (PAY, "pretend", "mixed"), mode
        assert self.accounts, "CREATE accounts first"
        if mode == "mixed":
            assert getattr(self, "dex_asset", None) is not None, \
                "setup_dex() first"
        self.stop_rate_run()
        clock = self.app.clock
        self._rate_state = {
            "mode": mode, "rate": float(rate),
            "deadline": clock.now() + float(duration),
            "dex_percent": int(dex_percent), "op_count": int(op_count),
            "submitted": 0, "status_counts": {}, "ticks": 0,
            "cursor": 0, "carry": 0.0, "last": clock.now(),
            "running": True, "stopped": False,
        }
        self._rate_timer = VirtualTimer(clock, owner=self.app)
        self._arm_rate_tick()
        return self.rate_status()

    def stop_rate_run(self) -> None:
        if self._rate_timer is not None:
            self._rate_timer.cancel()
            self._rate_timer = None
        if self._rate_state is not None:
            self._rate_state["running"] = False
            # an operator stop also voids batches already enqueued on
            # the scheduler (deadline expiry does NOT: the final tick's
            # batch covers the run's last second and must submit)
            self._rate_state["stopped"] = True

    def rate_status(self) -> dict:
        st = self._rate_state
        if st is None:
            return {"running": False}
        return {"running": st["running"], "mode": st["mode"],
                "rate": st["rate"], "ticks": st["ticks"],
                "submitted": st["submitted"],
                "status_counts": {str(k): v for k, v
                                  in st["status_counts"].items()},
                "remaining_seconds": round(
                    max(0.0, st["deadline"] - self.app.clock.now()), 3)}

    def _arm_rate_tick(self) -> None:
        t = self._rate_timer
        t.expires_from_now(RATE_TICK_SECONDS)
        t.async_wait(self._rate_tick)

    def _rate_tick(self) -> None:
        st = self._rate_state
        if st is None or not st["running"]:
            return
        clock = self.app.clock
        now = clock.now()
        want = st["rate"] * (now - st["last"]) + st["carry"]
        n = int(want)
        st["carry"] = want - n
        st["last"] = now
        st["ticks"] += 1
        if n > 0:
            # generation/submission runs as a fair-scheduled action, not
            # inside the timer callback; the batch binds ITS run's state
            # so a stop/start can never replay it against the new run
            self.app.scheduler.enqueue(
                "loadgen", lambda st=st, n=n: self._rate_generate(st, n))
        if now < st["deadline"]:
            self._arm_rate_tick()
        else:
            st["running"] = False
            self._rate_timer = None

    def _rate_generate(self, st: dict, n: int) -> None:
        from ..herder.tx_queue import TransactionQueue

        if st["stopped"]:
            return
        accts = self.accounts
        k = len(accts)
        for _ in range(n):
            i = st["cursor"]
            st["cursor"] += 1
            src = accts[i % k]
            if st["mode"] == "pretend":
                env = self.pretend_envelope(src, st["op_count"])
            elif st["mode"] == "mixed" and \
                    (i * 7919 + 13) % 100 < st["dex_percent"]:
                env = self.offer_envelope(
                    src, 10 + i % 90, 100 + (i % 50), 100)
            else:
                dest = accts[(i + 1) % k].public_key().raw
                # fee spread: sustained overload must exercise the
                # fee-rate eviction (and ban) path, which uniform fees
                # never trigger
                env = self.payment_envelope(src, dest, 1 + (i % 1000),
                                            fee=100 + (i % 16) * 25)
            r = self.app.herder.recv_transaction(env)
            st["submitted"] += 1
            st["status_counts"][r] = st["status_counts"].get(r, 0) + 1
            if r not in (TransactionQueue.ADD_STATUS_PENDING,
                         TransactionQueue.ADD_STATUS_DUPLICATE):
                # the queue did not take it: the cached seqnum must roll
                # back or every later tx from this source is a seq gap
                pub = src.public_key().raw
                if pub in self._seqs:
                    self._seqs[pub] -= 1

    # -- shared signing -----------------------------------------------------

    def _sign_tx(self, src: SecretKey, ops, fee: int):
        tx = T.Transaction.make(
            sourceAccount=T.muxed_account(src.public_key().raw),
            fee=fee,
            seqNum=self._next_seq(src),
            cond=T.Preconditions.make(T.PreconditionType.PRECOND_NONE),
            memo=T.MEMO_NONE_VALUE,
            operations=ops,
            ext=T.Transaction.fields[6][1].make(0))
        payload = T.TransactionSignaturePayload.make(
            networkId=self.network_id,
            taggedTransaction=T.TransactionSignaturePayload.fields[1][1]
            .make(T.EnvelopeType.ENVELOPE_TYPE_TX, tx))
        h = sha256(T.TransactionSignaturePayload.encode(payload))
        sig = T.DecoratedSignature.make(
            hint=signature_hint(src.public_key().raw),
            signature=src.sign(h))
        return T.TransactionEnvelope.make(
            T.EnvelopeType.ENVELOPE_TYPE_TX,
            T.TransactionV1Envelope.make(tx=tx, signatures=[sig]))

    # -- tx-based seeding (state-commitment-safe) ---------------------------

    def root_key(self) -> SecretKey:
        """The network root account key (standalone networks seed the
        genesis balance at SecretKey(network_id), like the reference's
        TestAccount::createRoot)."""
        return SecretKey(self.network_id)

    def create_account_envelopes(self, n: int, balance: int = 10**9,
                                 prefix: bytes = b"loadgen",
                                 batch: int = 100) -> List:
        """CreateAccount transactions from the network root, ``batch``
        ops per tx (ref LoadGenerator::createAccounts — REAL txs, so the
        bucket-list commitment covers the seeded accounts; the bulk
        create_accounts() writer is for in-process perf rigs only and
        leaves the SQL tier ahead of the buckets)."""
        root = self.root_key()
        new = [self.account_key(i, prefix) for i in range(n)]
        envs = []
        for i in range(0, len(new), batch):
            chunk = new[i:i + batch]
            ops = [T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.CREATE_ACCOUNT,
                    T.CreateAccountOp.make(
                        destination=T.account_id(sk.public_key().raw),
                        startingBalance=balance)))
                for sk in chunk]
            envs.append(self._sign_tx(root, ops, 100 * len(ops)))
        self.accounts.extend(new)
        return envs

    def create_dex_issuer_envelope(self) -> List:
        """Stage A of DEX seeding: create the LOAD issuer (its OWN close
        — apply order is hash-shuffled, so trustlines in the same ledger
        could apply before the issuer exists and fail NO_ISSUER)."""
        root = self.root_key()
        self._derive_dex()
        issuer = self.dex_issuer
        return [self._sign_tx(root, [T.Operation.make(
            sourceAccount=None,
            body=T.OperationBody.make(
                T.OperationType.CREATE_ACCOUNT,
                T.CreateAccountOp.make(
                    destination=T.account_id(issuer.public_key().raw),
                    startingBalance=10**9)))], 100)]

    def setup_dex_envelopes(self, credit: int = 10**7,
                            accounts: Optional[List[SecretKey]] = None
                            ) -> List:
        """Stage B of DEX seeding: one changeTrust per account (each
        account signs its own; run AFTER the issuer-create tx closed)."""
        accts = accounts or self.accounts
        assert accts, "CREATE accounts first"
        assert getattr(self, "dex_asset", None) is not None, \
            "create_dex_issuer_envelope first"
        envs = []
        for sk in accts:
            envs.append(self._sign_tx(sk, [T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.CHANGE_TRUST,
                    T.ChangeTrustOp.make(
                        line=T.ChangeTrustAsset.make(
                            self.dex_asset.type, self.dex_asset.value),
                        limit=U.INT64_MAX)))], 100))
        return envs

    def fund_dex_envelopes(self, credit: int = 10**7, batch: int = 100,
                           accounts: Optional[List[SecretKey]] = None
                           ) -> List:
        """Issuer payments funding every trustline (run AFTER the
        setup_dex_envelopes txs have closed)."""
        accts = accounts or self.accounts
        envs = []
        for i in range(0, len(accts), batch):
            chunk = accts[i:i + batch]
            ops = [T.Operation.make(
                sourceAccount=None,
                body=T.OperationBody.make(
                    T.OperationType.PAYMENT,
                    T.PaymentOp.make(
                        destination=T.muxed_account(sk.public_key().raw),
                        asset=self.dex_asset, amount=credit)))
                for sk in chunk]
            envs.append(self._sign_tx(self.dex_issuer, ops,
                                      100 * len(ops)))
        return envs
