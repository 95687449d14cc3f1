"""SignatureChecker: weighted-threshold multisig evaluation
(ref src/transactions/SignatureChecker.cpp:31-120).

Holds a tx's DecoratedSignatures; ``check_signature`` consumes them against
a signer set until the needed weight is reached; ``check_all_signatures_
used`` enforces txBAD_AUTH_EXTRA semantics.  The actual ed25519 verify
routes through the pluggable crypto backend (CPU libsodium-class or the
batched TPU kernel — the --crypto-backend=tpu seam, SURVEY.md §7).
"""
from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Sequence, Tuple

from ..crypto import verify_sig
from ..xdr import types as T


def signature_hint(pubkey: bytes) -> bytes:
    """Last 4 bytes of the key (ref SignatureUtils::getHint)."""
    return pubkey[-4:]


class SignatureChecker:
    def __init__(self, tx_hash: bytes, signatures: Sequence,
                 verify: Optional[Callable[[bytes, bytes, bytes], bool]]
                 = None):
        self.tx_hash = tx_hash
        self.signatures = list(signatures)
        # hints never change: precompute once (check_signature runs ~7x
        # per tx across admission, nomination and apply)
        self._hints = [ds.hint for ds in self.signatures]
        self.used = [False] * len(self.signatures)
        self._verify = verify or verify_sig

    def check_signature(self, signers: List[Tuple[object, int]],
                        needed_weight: int) -> bool:
        """signers: [(SignerKey value, weight)]; consume matching signatures
        until total weight >= needed_weight.

        Mirrors the reference's structure EXACTLY (SignatureChecker.cpp
        :31-135): signers split by key type; pre-auth-tx keys tallied
        first against the tx hash; then HASH_X, ED25519, SIGNED_PAYLOAD
        groups each scanned signatures-outer/signers-inner with a matched
        signer retired per signature.  The type-major order is
        observable: it decides WHICH signatures get marked used
        (txBAD_AUTH_EXTRA).  Callers pre-filter disabled master keys
        (account_signers), matching the reference's caller-side gate.
        Weights saturate at 255 (uint8)."""
        total = 0
        SK = T.SignerKeyType
        groups: dict = {}
        for skey, weight in signers:
            groups.setdefault(skey.type, []).append((skey, weight))

        # pre-auth-tx signers match the tx hash directly, no signature
        for skey, weight in groups.get(
                SK.SIGNER_KEY_TYPE_PRE_AUTH_TX, ()):
            if skey.value == self.tx_hash:
                total += min(weight, 255)
                if total >= needed_weight:
                    return True

        hints = self._hints

        def verify_all(group, match) -> bool:
            nonlocal total
            for i, ds in enumerate(self.signatures):
                hint = hints[i]
                for j, (skey, weight) in enumerate(group):
                    if not match(ds, hint, skey):
                        continue
                    self.used[i] = True
                    total += min(weight, 255)
                    if total >= needed_weight:
                        return True
                    group.pop(j)
                    break
            return False

        def match_hash_x(ds, hint, skey) -> bool:
            return (hint == skey.value[-4:]
                    and hashlib.sha256(ds.signature).digest()
                    == skey.value)

        def match_ed25519(ds, hint, skey) -> bool:
            pub = skey.value
            return (hint == pub[-4:]
                    and self._verify(pub, ds.signature, self.tx_hash))

        def match_payload(ds, hint, skey) -> bool:
            sp = skey.value
            pub = sp.ed25519
            # hint = payload-hint XOR key-hint (protocol 19)
            ph = sp.payload[-4:].ljust(4, b"\x00")
            want = bytes(a ^ b for a, b in zip(pub[-4:], ph))
            return (hint == want
                    and self._verify(pub, ds.signature, sp.payload))

        for key_type, match in (
                (SK.SIGNER_KEY_TYPE_HASH_X, match_hash_x),
                (SK.SIGNER_KEY_TYPE_ED25519, match_ed25519),
                (SK.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                 match_payload)):
            group = groups.get(key_type)
            if group and verify_all(group, match):
                return True
        return False

    def check_all_signatures_used(self) -> bool:
        return all(self.used)


def account_signers(account_entry) -> List[Tuple[object, int]]:
    """Master key + additional signers as (SignerKey, weight) pairs.

    A DISABLED master key (thresholds[0] == 0) is omitted entirely,
    mirroring the reference caller (TransactionFrame::checkSignature
    :306-310) — a weight-0 master key must never consume its matching
    signature, or txBAD_AUTH_EXTRA outcomes diverge.  Additional signers
    with weight 0 cannot exist on-ledger (SetOptions weight 0 deletes)."""
    acc = account_entry
    out: List[Tuple[object, int]] = []
    mw = acc.thresholds[0]
    if mw:
        out.append((
            T.SignerKey.make(T.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                             acc.accountID.value),
            mw,
        ))
    for s in acc.signers:
        out.append((s.key, s.weight))
    return out
