"""XDR wire/canonical format (ref src/protocol-curr/xdr + xdrpp runtime;
codegen ref src/Makefile.am:42-47).

``runtime`` holds the combinator engine; ``types`` the protocol-19 schema.
"""
from . import runtime, types  # noqa: F401
from .runtime import XdrError  # noqa: F401


def xdr_sha256(xdr_type, value) -> bytes:
    """sha256 of the canonical encoding (ref src/crypto/SHA.h xdrSha256)."""
    from ..crypto import sha256

    return sha256(xdr_type.encode(value))
