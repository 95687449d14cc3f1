"""SCPDriver: the abstract callback surface binding consensus to the host
application (ref src/scp/SCPDriver.h:66-256 — implemented by the Herder).

SCP itself knows nothing of transactions, ledgers, or networking
(ref src/scp/readme.md:3-13); everything external goes through this class.
"""
from __future__ import annotations

import hashlib
from enum import IntEnum
from typing import Callable, Optional


class ValidationLevel(IntEnum):
    """Driver verdicts on candidate values (ref SCPDriver.h ValidationLevel)."""

    INVALID = 0
    MAYBE_VALID = 1          # valid structure, can't fully check yet
    FULLY_VALIDATED = 2
    VOTE_TO_NOMINATE = 3     # fully valid + worth nominating ourselves


class SCPDriver:
    """Subclass and override.  All methods that must be provided raise."""

    # -- value semantics ---------------------------------------------------

    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        raise NotImplementedError

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        """Optionally repair a MAYBE_VALID value into a valid one."""
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: set) -> Optional[bytes]:
        """Deterministically merge the candidate set into one composite."""
        raise NotImplementedError

    # -- envelope plumbing -------------------------------------------------

    def sign_envelope(self, envelope) -> None:
        """Fill envelope.signature over the statement."""
        raise NotImplementedError

    def verify_envelope(self, envelope) -> bool:
        raise NotImplementedError

    def emit_envelope(self, envelope) -> None:
        """Broadcast a newly-produced envelope to the network."""
        raise NotImplementedError

    def get_qset(self, qset_hash: bytes):
        """Resolve a quorum-set hash to an SCPQuorumSet (or None)."""
        raise NotImplementedError

    # -- nomination leader election weights --------------------------------

    def compute_hash_node(self, slot_index: int, prev_value: bytes,
                          is_priority: bool, round_num: int,
                          node_id: bytes) -> int:
        """Deterministic per-(slot, round, node) 64-bit hash used for leader
        priority/neighborhood (ref SCPDriver::computeHashNode)."""
        tag = b"\x00\x00\x00\x02" if is_priority else b"\x00\x00\x00\x01"
        h = hashlib.sha256(
            slot_index.to_bytes(8, "big") + prev_value + tag
            + round_num.to_bytes(4, "big") + node_id
        ).digest()
        return int.from_bytes(h[:8], "big")

    def compute_value_hash(self, slot_index: int, prev_value: bytes,
                           round_num: int, value: bytes) -> int:
        h = hashlib.sha256(
            slot_index.to_bytes(8, "big") + prev_value + b"\x00\x00\x00\x03"
            + round_num.to_bytes(4, "big") + value
        ).digest()
        return int.from_bytes(h[:8], "big")

    def compute_timeout(self, round_number: int, is_nomination: bool) -> float:
        """Seconds before re-arming a round timer; linear back-off capped
        (ref SCPDriver::computeTimeout: min(roundNumber + 1, 240)s)."""
        return float(min(round_number + 1, 240))

    # -- timers ------------------------------------------------------------

    def setup_timer(self, slot_index: int, timer_id: int, timeout: float,
                    cb: Optional[Callable[[], None]]) -> None:
        """Arm (or with cb=None cancel) a per-slot timer.  timer_id 0 =
        nomination, 1 = ballot (ref Slot::timerIDs)."""
        raise NotImplementedError

    # -- notifications (optional hooks) ------------------------------------

    def value_externalized(self, slot_index: int, value: bytes) -> None:
        pass

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        pass

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        pass

    def updated_candidate_value(self, slot_index: int,
                                composite: bytes) -> None:
        pass

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def accepted_commit(self, slot_index: int, ballot) -> None:
        pass

    def ballot_did_hear_from_quorum(self, slot_index: int, ballot) -> None:
        pass


NOMINATION_TIMER = 0
BALLOT_TIMER = 1
