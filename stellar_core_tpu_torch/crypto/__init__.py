"""Host-side crypto for the port: the ed25519 spec copy and SHA-256."""
from .sha import sha256  # noqa: F401
