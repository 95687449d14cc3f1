"""SCP façade: one instance per node; slot map + envelope routing
(ref src/scp/SCP.h:23, SCP.cpp).  The port's copy of the JAX package's
``scp/scp.py``, with the tally device as one more argument.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.device import default_device
from .driver import SCPDriver
from .local_node import LocalNode
from .slot import EnvelopeState, Slot
from .timeline import SCPTimeline


class SCP:
    def __init__(self, driver: SCPDriver, node_id: bytes, is_validator: bool,
                 qset, tally_backend: str = "host",
                 timeline: Optional[SCPTimeline] = None, device=None):
        self.driver = driver
        self.local_node = LocalNode(node_id, qset, is_validator)
        self.slots: Dict[int, Slot] = {}
        # "host" | "tensor" | "both": route federated tallies through the
        # port's quorum ops (ops/quorum.py) on ``tally_device``, optionally
        # with the host oracle asserting equality (see scp/tally.py).  The
        # device is resolved only for a tensor backend: ``cuda`` unless
        # ``device`` names another, raising where there is no GPU.
        self.tally_backend = tally_backend
        self.tally_device = (default_device(device)
                             if tally_backend != "host" else None)
        # per-slot forensic timeline (scp/timeline.py): disabled inert
        # recorder unless the host installs an enabled one.  The ring is
        # deliberately independent of purge_slots — forensics outlives
        # the protocol state it describes.
        self.timeline = timeline if timeline is not None else SCPTimeline()

    # -- slots -------------------------------------------------------------

    def get_slot(self, slot_index: int, create: bool = True
                 ) -> Optional[Slot]:
        s = self.slots.get(slot_index)
        if s is None and create:
            s = Slot(slot_index, self)
            self.slots[slot_index] = s
        return s

    def purge_slots(self, max_slot_index: int, slot_to_keep: int) -> None:
        """Drop state for slots below ``max_slot_index`` except
        ``slot_to_keep`` (ref SCP::purgeSlots)."""
        for idx in list(self.slots):
            if idx < max_slot_index and idx != slot_to_keep:
                del self.slots[idx]

    # -- protocol entry points ---------------------------------------------

    def receive_envelope(self, envelope) -> EnvelopeState:
        if not self.driver.verify_envelope(envelope):
            return EnvelopeState.INVALID
        slot_index = envelope.statement.slotIndex
        return self.get_slot(slot_index).process_envelope(envelope)

    def nominate(self, slot_index: int, value: bytes,
                 previous_value: bytes) -> bool:
        assert self.local_node.is_validator
        return self.get_slot(slot_index).nominate(value, previous_value)

    def stop_nomination(self, slot_index: int) -> None:
        s = self.get_slot(slot_index, create=False)
        if s is not None:
            s.stop_nomination()

    # -- introspection -----------------------------------------------------

    def get_latest_messages_send(self, slot_index: int) -> List:
        s = self.get_slot(slot_index, create=False)
        return s.latest_messages_send() if s is not None else []

    def get_current_state_envelopes(self, slot_index: int) -> List:
        """Full remembered state of one slot — every node's latest
        envelopes, for answering GET_SCP_STATE (ref processCurrentState)."""
        s = self.get_slot(slot_index, create=False)
        return s.current_state_envelopes() if s is not None else []

    def empty(self) -> bool:
        return not self.slots

    def get_high_slot_index(self) -> int:
        return max(self.slots) if self.slots else 0

    def get_externalized_value(self, slot_index: int) -> Optional[bytes]:
        s = self.get_slot(slot_index, create=False)
        return s.ballot.externalized_value() if s is not None else None
