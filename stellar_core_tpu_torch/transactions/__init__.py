"""Transaction subsystem (ref src/transactions — SURVEY.md §2.5)."""
from .frame import (  # noqa: F401
    TransactionFrame, ValidationResult, tx_frame_from_envelope,
)
from .signature_checker import SignatureChecker, account_signers  # noqa: F401
