"""Fuzzing harnesses: tx-mode and overlay-mode
(ref src/test/FuzzerImpl.{h,cpp} + docs/fuzzing.md — the reference's AFL
`fuzz`/`gen-fuzz` subcommands; here deterministic seeded generators usable
both from pytest and the CLI).

- TxFuzzer: builds structurally-random operations against a canned ledger
  and applies them through the full TransactionFrame path.  Any outcome is
  acceptable EXCEPT an uncontrolled exception (InvariantDoesNotHold or a
  raw crash) — mirroring the reference's "apply fuzzer-built ops against a
  canned ledger" mode.
- OverlayFuzzer: feeds mutated/garbage byte streams into Peer.recv_bytes —
  the peer must close cleanly, never throw.
- XdrFuzzer: random bytes through every registered XDR type: decode either
  raises XdrError or produces a value that re-encodes canonically.
"""
from __future__ import annotations

import random
from typing import List, Optional

from .crypto import SecretKey, sha256
from .xdr import types as T


class TxFuzzer:
    """ref FuzzerImpl tx mode: signature checks are bypassed (the
    reference compiles them out under FUZZING_BUILD_MODE...; here a
    constant-true verify callable) so the fuzz explores apply logic, not
    signature rejection."""

    NUM_ACCOUNTS = 8

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        from .ledger.ledger_txn import LedgerTxn, LedgerTxnRoot, \
            open_database
        from .transactions import utils as U

        self.db = open_database(":memory:")
        self.root = LedgerTxnRoot(self.db)
        self.network_id = sha256(b"fuzz network")
        self.keys = [SecretKey(sha256(b"fuzz-%d" % i))
                     for i in range(self.NUM_ACCOUNTS)]

        with LedgerTxn(self.root) as ltx:
            ltx.set_header(self._genesis_header())
            ltx.commit()
        with LedgerTxn(self.root) as ltx:
            for i, sk in enumerate(self.keys):
                ltx.put(U.make_account_entry(
                    sk.public_key().raw, 10**12, seq_num=0))
            ltx.commit()

    @staticmethod
    def _genesis_header():
        sv = T.StellarValue.make(
            txSetHash=b"\x00" * 32, closeTime=1000, upgrades=[],
            ext=T.StellarValue.fields[3][1].make(
                T.StellarValueType.STELLAR_VALUE_BASIC))
        return T.LedgerHeader.make(
            ledgerVersion=19, previousLedgerHash=b"\x00" * 32,
            scpValue=sv, txSetResultHash=b"\x00" * 32,
            bucketListHash=b"\x00" * 32, ledgerSeq=1,
            totalCoins=10**18, feePool=0, inflationSeq=0, idPool=0,
            baseFee=100, baseReserve=5000000, maxTxSetSize=100,
            skipList=[b"\x00" * 32] * 4,
            ext=T.LedgerHeader.fields[14][1].make(0))

    # -- random structure generators ----------------------------------------

    def _acct(self) -> bytes:
        return self.rng.choice(self.keys).public_key().raw

    def _amount(self) -> int:
        return self.rng.choice(
            [0, 1, -1, 100, 10**7, 2**63 - 1, -(2**63),
             self.rng.randrange(0, 10**10)])

    def _asset(self):
        from .transactions import utils as U

        if self.rng.random() < 0.5:
            return U.asset_native()
        code = bytes(self.rng.randrange(32, 127)
                     for _ in range(self.rng.randrange(1, 5)))
        return U.make_asset(code, self._acct())

    def _price(self):
        return T.Price.make(n=self.rng.randrange(-3, 1000),
                            d=self.rng.randrange(-3, 1000))

    def random_operation(self):
        OT = T.OperationType
        choice = self.rng.randrange(10)
        if choice == 0:
            body = T.OperationBody.make(OT.CREATE_ACCOUNT,
                                        T.CreateAccountOp.make(
                                            destination=T.account_id(
                                                self._acct()),
                                            startingBalance=self._amount()))
        elif choice == 1:
            body = T.OperationBody.make(OT.PAYMENT, T.PaymentOp.make(
                destination=T.muxed_account(self._acct()),
                asset=self._asset(), amount=self._amount()))
        elif choice == 2:
            body = T.OperationBody.make(
                OT.MANAGE_SELL_OFFER, T.ManageSellOfferOp.make(
                    selling=self._asset(), buying=self._asset(),
                    amount=self._amount(), price=self._price(),
                    offerID=self.rng.choice([0, 1, -5, 10**6])))
        elif choice == 3:
            a = self._asset()
            body = T.OperationBody.make(
                OT.CHANGE_TRUST, T.ChangeTrustOp.make(
                    line=T.ChangeTrustAsset.make(a.type, a.value),
                    limit=self._amount()))
        elif choice == 4:
            body = T.OperationBody.make(
                OT.CREATE_CLAIMABLE_BALANCE,
                T.CreateClaimableBalanceOp.make(
                    asset=self._asset(), amount=self._amount(),
                    claimants=[T.Claimant.make(
                        T.ClaimantType.CLAIMANT_TYPE_V0,
                        T.Claimant.arms[0][1].make(
                            destination=T.account_id(self._acct()),
                            predicate=T.ClaimPredicate.make(
                                T.ClaimPredicateType
                                .CLAIM_PREDICATE_UNCONDITIONAL)))]))
        elif choice == 5:
            body = T.OperationBody.make(
                OT.BEGIN_SPONSORING_FUTURE_RESERVES,
                T.BeginSponsoringFutureReservesOp.make(
                    sponsoredID=T.account_id(self._acct())))
        elif choice == 6:
            body = T.OperationBody.make(
                OT.END_SPONSORING_FUTURE_RESERVES, None)
        elif choice == 7:
            body = T.OperationBody.make(
                OT.ACCOUNT_MERGE, T.muxed_account(self._acct()))
        elif choice == 8:
            body = T.OperationBody.make(
                OT.BUMP_SEQUENCE, T.BumpSequenceOp.make(
                    bumpTo=self._amount()))
        else:
            body = T.OperationBody.make(
                OT.MANAGE_DATA, T.ManageDataOp.make(
                    dataName=bytes(self.rng.randrange(32, 127)
                                   for _ in range(
                                       self.rng.randrange(1, 10))),
                    dataValue=(None if self.rng.random() < 0.3 else
                               bytes(self.rng.randrange(256)
                                     for _ in range(8)))))
        src = None
        if self.rng.random() < 0.3:
            src = T.muxed_account(self._acct())
        return T.Operation.make(sourceAccount=src, body=body)

    def run_one(self) -> Optional[str]:
        """Build + apply one random tx.  Returns None (survived) or a
        crash description."""
        from .ledger.ledger_txn import LedgerTxn
        from .transactions import TransactionFrame

        sk = self.rng.choice(self.keys)
        n_ops = self.rng.randrange(1, 4)
        ops = [self.random_operation() for _ in range(n_ops)]
        with LedgerTxn(self.root) as probe:
            e = probe.load_account(sk.public_key().raw)
            seq = e.data.value.seqNum if e is not None else 0
            probe.rollback()
        tx = T.Transaction.make(
            sourceAccount=T.muxed_account(sk.public_key().raw),
            fee=self.rng.choice([0, 100, 10**6]),
            seqNum=seq + 1,
            cond=T.Preconditions.make(T.PreconditionType.PRECOND_NONE),
            memo=T.MEMO_NONE_VALUE,
            operations=ops,
            ext=T.Transaction.fields[6][1].make(0))
        env = T.TransactionEnvelope.make(
            T.EnvelopeType.ENVELOPE_TYPE_TX,
            T.TransactionV1Envelope.make(tx=tx, signatures=[]))
        try:
            frame = TransactionFrame(self.network_id, env)
            with LedgerTxn(self.root) as ltx:
                frame.process_fee_seq_num(ltx, base_fee=100)
                frame.apply(ltx, verify=lambda *a: True)
                ltx.commit()
        except Exception as e:  # noqa: BLE001 — the fuzz oracle
            return f"{type(e).__name__}: {e}"
        return None

    def run(self, iterations: int) -> List[str]:
        crashes = []
        for i in range(iterations):
            r = self.run_one()
            if r is not None:
                crashes.append(f"iter {i}: {r}")
        return crashes


class OverlayFuzzer:
    """ref FuzzerImpl overlay mode: bytes into the peer pipeline."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def _garbage(self) -> bytes:
        n = self.rng.randrange(0, 400)
        return bytes(self.rng.randrange(256) for _ in range(n))

    def _mutated_hello(self, app) -> bytes:
        """A real HELLO frame with random byte flips."""
        from .xdr import overlay_types as O

        hello = O.Hello.make(
            ledgerVersion=19, overlayVersion=28, overlayMinVersion=27,
            networkID=app.config.network_id(), versionStr=b"fuzz",
            listeningPort=11625, peerID=T.account_id(app.config.node_id()),
            cert=O.AuthCert.make(
                pubkey=T.Curve25519Public.make(key=b"\x01" * 32),
                expiration=2**40,
                sig=b"\x00" * 64),
            nonce=b"\x07" * 32)
        msg = O.StellarMessage.make(O.MessageType.HELLO, hello)
        am = O.AuthenticatedMessage.make(
            0, O.AuthenticatedMessage.arms[0][1].make(
                sequence=0, message=msg,
                mac=T.HmacSha256Mac.make(mac=b"\x00" * 32)))
        data = bytearray(O.AuthenticatedMessage.encode(am))
        for _ in range(self.rng.randrange(0, 8)):
            data[self.rng.randrange(len(data))] = self.rng.randrange(256)
        return bytes(data)

    def run(self, iterations: int) -> List[str]:
        from .main import Application, test_config
        from .overlay.manager import OverlayManager
        from .overlay.peer import Peer, PeerRole
        from .utils.clock import ClockMode, VirtualClock

        crashes = []
        app = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                          test_config())
        app.overlay_manager = OverlayManager(app)
        app.start()

        class SinkPeer(Peer):
            def transport_write(self, data: bytes) -> None:
                pass

        for i in range(iterations):
            peer = SinkPeer(app, PeerRole.ACCEPTOR)
            app.overlay_manager.add_pending_peer(peer)
            payload = (self._mutated_hello(app)
                       if self.rng.random() < 0.5 else self._garbage())
            try:
                peer.recv_bytes(payload)
                # follow-up garbage on whatever state it reached
                peer.recv_bytes(self._garbage())
            except Exception as e:  # noqa: BLE001
                crashes.append(f"iter {i}: {type(e).__name__}: {e}")
        return crashes


class XdrFuzzer:
    """Random bytes through the XDR codec: decode raises XdrError or the
    value re-encodes (no crashes, no infinite recursion)."""

    TYPES = ["TransactionEnvelope", "LedgerEntry", "LedgerHeader",
             "SCPEnvelope", "TransactionResult", "LedgerKey",
             "ClaimPredicate"]

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def run(self, iterations: int) -> List[str]:
        from .xdr.runtime import XdrError

        crashes = []
        for i in range(iterations):
            tname = self.rng.choice(self.TYPES)
            t = getattr(T, tname)
            data = bytes(self.rng.randrange(256)
                         for _ in range(self.rng.randrange(0, 300)))
            try:
                v = t.decode(data)
            except XdrError:
                continue
            except Exception as e:  # noqa: BLE001
                crashes.append(
                    f"iter {i} {tname}: {type(e).__name__}: {e}")
                continue
            try:
                t.encode(v)
            except Exception as e:  # noqa: BLE001
                crashes.append(
                    f"iter {i} {tname} re-encode: "
                    f"{type(e).__name__}: {e}")
        return crashes
