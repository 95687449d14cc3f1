"""Host-side crypto of the port (ref: src/crypto — SURVEY.md §2.6): the
same exports as the JAX package's ``crypto``.

Every transaction-signature verify outside a close's batch routes through
:func:`ed25519.verify_sig` (OpenSSL when the ``cryptography`` package is
installed, else the spec copy ``ed25519_ref``); a close's batch runs on the
node's device through ``ops/ed25519_cuda.py`` (``herder/tx_set.py``).
"""
from .sha import (  # noqa: F401
    sha256, SHA256, blake2, hmac_sha256, hkdf_extract, hkdf_expand,
)
from .ed25519 import SecretKey, PublicKey, verify_sig, sign  # noqa: F401
from .strkey import (  # noqa: F401
    encode_ed25519_public_key,
    decode_ed25519_public_key,
    encode_ed25519_seed,
    decode_ed25519_seed,
)
from .shorthash import shorthash, shorthash_init  # noqa: F401
