"""The one traffic generator: payment envelopes as wire bytes, from a seed.

Every cell's traffic is a data file of parameters (``workloads/*.json``)
that this module reads.  The program receives only the bytes made here.

The XDR layout is that of ``stellar_core_tpu_torch/simulation/
load_generator.py`` (``payment_envelope``, ``create_account_envelopes``)
and ``xdr/types.py`` at commit d11364c, written out by hand: a v1
``TransactionEnvelope`` (``ENVELOPE_TYPE_TX``) with no preconditions, no
memo and one ed25519 ``DecoratedSignature`` over
``sha256(networkId || ENVELOPE_TYPE_TX || Transaction)``.

Keys and signatures are made without OpenSSL, fast enough for 100,000
envelopes in a set-up: account i's secret scalar is ``a0 + i`` and the
j-th signature's nonce is ``r0 + j`` (``a0``, ``r0`` drawn from the seed),
so each public key and each R is one point addition from the last, and
the affine encodings share one inversion.  Each signature is a valid
ed25519 signature (S = r + H(R, A, M) a mod L); only the nonce is not RFC
8032's hash of the message, which no verifier can see.
"""
from __future__ import annotations

import hashlib
import struct
from typing import NamedTuple

import numpy as np

from .reference import ed25519 as ref

ENVELOPE_TYPE_TX = 2
OP_CREATE_ACCOUNT = 0
OP_PAYMENT = 1
BASE_FEE = 100
_B = ref.to_extended(ref.B)


def _u32(v: int) -> bytes:
    return struct.pack(">I", v)


def _i64(v: int) -> bytes:
    return struct.pack(">q", v)


def network_id(passphrase: str) -> bytes:
    return hashlib.sha256(passphrase.encode()).digest()


def encode_many(points) -> list[bytes]:
    """Affine encodings of extended points, with one field inversion for
    all of them (Montgomery's trick)."""
    p = ref.P
    prefix, acc = [], 1
    for pt in points:
        prefix.append(acc)
        acc = acc * pt[2] % p
    inv = pow(acc, p - 2, p)
    out = [b""] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z, _ = points[i]
        zi = inv * prefix[i] % p
        inv = inv * z % p
        x, y = x * zi % p, y * zi % p
        out[i] = (y | ((x & 1) << 255)).to_bytes(32, "little")
    return out


def _scalar(seed: int, label: bytes) -> int:
    h = hashlib.sha512(label + seed.to_bytes(16, "little")).digest()
    return int.from_bytes(h, "little") % ref.L


class Keys:
    """``n`` account keys from ``seed``: scalars ``a0 + i`` and their
    public keys ``A_i = A_{i-1} + B``."""

    def __init__(self, seed: int, n: int, label: bytes = b"accounts"):
        a0 = _scalar(seed, b"benchmark-" + label)
        self.scalars = [(a0 + i) % ref.L for i in range(n)]
        pts, q = [], ref.scalar_mult_base(a0)
        for _ in range(n):
            pts.append(q)
            q = ref.point_add(q, _B)
        self.public = encode_many(pts)


def root_key(net_id: bytes) -> tuple[int, bytes]:
    """The genesis root account's (scalar, public key): its seed is the
    network id."""
    a, _ = ref.expand_seed(net_id)
    return a, ref.encode_point(ref.scalar_mult_base(a))


class Signer:
    """Signs 32-byte payload hashes with sequential nonces from ``seed``."""

    def __init__(self, seed: int):
        self.r = _scalar(seed, b"benchmark-nonces")
        self.R = ref.scalar_mult_base(self.r)

    def sign_many(self, items) -> list[bytes]:
        """``items``: (secret scalar, public key, 32-byte hash) triples."""
        rs, pts = [], []
        for _ in items:
            rs.append(self.r)
            pts.append(self.R)
            self.r += 1
            self.R = ref.point_add(self.R, _B)
        out = []
        for (a, pub, h), r, rb in zip(items, rs, encode_many(pts)):
            k = ref.hram(rb, pub, h)
            out.append(rb + ((r + k * a) % ref.L).to_bytes(32, "little"))
        return out


def op_payment(dest: bytes, amount: int) -> bytes:
    """A native PaymentOp with no source account."""
    return (_u32(0) + _u32(OP_PAYMENT) + _u32(0) + dest + _u32(0)
            + _i64(amount))


def op_create_account(dest: bytes, balance: int) -> bytes:
    return (_u32(0) + _u32(OP_CREATE_ACCOUNT) + _u32(0) + dest
            + _i64(balance))


def transaction(src: bytes, fee: int, seq: int, ops: list[bytes]) -> bytes:
    return (_u32(0) + src + _u32(fee) + _i64(seq) + _u32(0) + _u32(0)
            + _u32(len(ops)) + b"".join(ops) + _u32(0))


def tx_hash(net_id: bytes, tx: bytes) -> bytes:
    return hashlib.sha256(net_id + _u32(ENVELOPE_TYPE_TX) + tx).digest()


def envelope(tx: bytes, hint: bytes, sig: bytes) -> bytes:
    return (_u32(ENVELOPE_TYPE_TX) + tx + _u32(1) + hint + _u32(len(sig))
            + sig)


def tx_set(prev_hash: bytes, envelopes: list[bytes]) -> bytes:
    """A ``TransactionSet``: the previous ledger's hash and the envelopes."""
    return prev_hash + _u32(len(envelopes)) + b"".join(envelopes)


def forge(sig: bytes) -> bytes:
    """The signature with its S's lowest bit flipped: S stays canonical, so
    a verifier does all its work before it refuses."""
    return sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]


class Envelope(NamedTuple):
    """One generated transaction: what the reference needs to judge it."""

    src: int          # account index (-1: the root)
    seq: int
    fee: int
    ops: tuple        # (kind, dest index, amount) of each operation
    hash: bytes
    pub: bytes
    sig: bytes
    forged: bool
    wire: bytes


class Traffic:
    """Payments among ``n_accounts`` seeded accounts (and the root's
    CreateAccount transactions that fund them), signed as ``Signer``
    does; the workload's parameters fix the sizes, ``seed`` every choice."""

    def __init__(self, seed: int, passphrase: str, n_accounts: int,
                 balance: int, amount_max: int):
        self.seed = seed
        self.net_id = network_id(passphrase)
        self.keys = Keys(seed, n_accounts)
        self.root_scalar, self.root_pub = root_key(self.net_id)
        self.signer = Signer(seed)
        self.balance = balance
        self.amount_max = amount_max
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32])

    @property
    def n_accounts(self) -> int:
        return len(self.keys.public)

    def pub(self, i: int) -> bytes:
        return self.root_pub if i < 0 else self.keys.public[i]

    def _sign(self, txs, forged) -> list[Envelope]:
        """``txs``: (src, seq, fee, ops, tx bytes) -> envelopes."""
        items, hashes = [], []
        for src, _, _, _, tx in txs:
            h = tx_hash(self.net_id, tx)
            hashes.append(h)
            a = self.root_scalar if src < 0 else self.keys.scalars[src]
            items.append((a, self.pub(src), h))
        sigs = self.signer.sign_many(items)
        out = []
        for (src, seq, fee, ops, tx), h, sig, bad in zip(txs, hashes, sigs,
                                                         forged):
            pub = self.pub(src)
            if bad:
                sig = forge(sig)
            out.append(Envelope(src, seq, fee, ops, h, pub, sig, bad,
                                envelope(tx, pub[-4:], sig)))
        return out

    def create_accounts(self, root_seq: int, per_tx: int = 100
                        ) -> list[Envelope]:
        """The root's CreateAccount transactions for every account,
        ``per_tx`` operations each, from sequence ``root_seq + 1`` on."""
        txs = []
        for k, lo in enumerate(range(0, self.n_accounts, per_tx)):
            idx = range(lo, min(lo + per_tx, self.n_accounts))
            ops = tuple(("create", i, self.balance) for i in idx)
            raw = [op_create_account(self.keys.public[i], self.balance)
                   for i in idx]
            fee = BASE_FEE * len(raw)
            seq = root_seq + 1 + k
            txs.append((-1, seq, fee, ops,
                        transaction(self.root_pub, fee, seq, raw)))
        return self._sign(txs, [False] * len(txs))

    def payments(self, sources, seqs, n_forged: int) -> list[Envelope]:
        """One single-operation payment from each account of ``sources``
        (in that order) at its sequence number in ``seqs``, to another
        account drawn from the seed, of 1..``amount_max`` stroops;
        ``n_forged`` of them, at positions drawn from the seed, carry a
        forged signature."""
        n = len(sources)
        dests = self.rng.integers(0, self.n_accounts - 1, n)
        amounts = self.rng.integers(1, self.amount_max + 1, n)
        forged = np.zeros(n, bool)
        forged[self.rng.choice(n, n_forged, replace=False)] = True
        txs = []
        for src, seq, d, amt in zip(sources, seqs, dests.tolist(),
                                    amounts.tolist()):
            dest = d + (d >= src)       # any account but the source
            tx = transaction(self.keys.public[src], BASE_FEE, seq,
                             [op_payment(self.keys.public[dest], amt)])
            txs.append((src, seq, BASE_FEE, (("pay", dest, amt),), tx))
        return self._sign(txs, forged.tolist())

    def ledger(self, next_seq: list[int], per_ledger: int,
               n_forged: int) -> list[Envelope]:
        """One ledger's payments: one from each of ``per_ledger`` accounts
        drawn from the seed, in an order drawn from it, at the sequence
        numbers of ``next_seq``, which advances for each sound one."""
        order = self.rng.permutation(self.n_accounts)[:per_ledger].tolist()
        envs = self.payments(order, [next_seq[i] for i in order], n_forged)
        for e in envs:
            if not e.forged:
                next_seq[e.src] += 1
        return envs
