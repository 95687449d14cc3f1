"""Per-slot SCP timeline recorder — the consensus-forensics substrate.

Every protocol-visible transition of a slot's state machines (nomination
round starts, votes/accepts/candidates, ballot PREPARE→CONFIRM→
EXTERNALIZE steps, timer arms/fires, heard-quorum flips, every inbound
envelope with its verdict) lands as one small dict in a bounded
per-slot ring.  The recorder is strictly WRITE-ONLY from consensus
code: `scp/`, `herder/` etc. may alias it, test ``.enabled`` and call
``.record(...)`` — nothing else (enforced statically by detlint's
``det-telemetry-readback`` rule), so telemetry-on and telemetry-off
closes stay bit-identical by construction.

Readers live outside the consensus scan: the HTTP ``scp?slot=N``
endpoint and the chaos engine's network-wide forensic aggregator
(simulation/chaos.py), which merges every node's export into one
cross-node slot timeline and attributes the first divergence of a
failing run (which node, which slot, which message).

Timestamps come from the app's clock: virtual time in simulations — so
a same-seed chaos rerun reproduces a byte-identical forensics dump —
and wall time on real nodes.

Statement summaries (``summarize_statement``) compact each SCP
statement into counters plus ``value_tag`` prefixes.  A value tag is
the first 40 bytes of the encoded StellarValue in hex — exactly the
(txSetHash, closeTime) prefix, so byte order on tags equals protocol
order on values for everything but upgrade-only differences, and
``is_newer_summary`` can mirror the reference's isNewerStatement order
over summaries alone.  That makes equivocation DETECTABLE from merged
timelines: two statements from one node for one slot that are neither
equal nor ordered (``find_equivocations``) are cryptographic-grade
evidence of a Byzantine emitter, witnessed by whichever honest nodes
recorded them.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..xdr import types as T
from . import statement as S

#: summary type names, protocol order for ballot statements
_TYPE_NAMES = {
    S.ST_PREPARE: "PREPARE",
    S.ST_CONFIRM: "CONFIRM",
    S.ST_EXTERNALIZE: "EXTERNALIZE",
    S.ST_NOMINATE: "NOMINATE",
}
_BALLOT_RANK = {"PREPARE": 0, "CONFIRM": 1, "EXTERNALIZE": 2}


def value_tag(value: Optional[bytes]) -> Optional[str]:
    """Order-preserving compact tag of one consensus value: the first
    40 bytes hex = (txSetHash, closeTime) of an encoded StellarValue.
    XDR is big-endian, so lexicographic order on tags equals the
    protocol's byte order on values up to upgrade-only differences."""
    if value is None:
        return None
    return value[:40].hex()


def _bt(b) -> Optional[list]:
    """XDR ballot -> [counter, value_tag] (None passes through)."""
    if b is None:
        return None
    return [b.counter, value_tag(b.value)]


def statement_fingerprint(st) -> str:
    """Short content hash of one statement's exact bytes — the identity
    equivocation evidence hangs on."""
    from ..crypto import sha256

    return sha256(T.SCPStatement.encode(st))[:8].hex()


def summarize_statement(st) -> dict:
    """Compact, JSON-able summary carrying everything the reference's
    isNewerStatement order needs (counters + ordered value tags)."""
    t = S.pledge_type(st)
    p = st.pledges.value
    if t == S.ST_NOMINATE:
        return {"type": "NOMINATE",
                "votes": [value_tag(v) for v in p.votes],
                "accepted": [value_tag(v) for v in p.accepted]}
    if t == S.ST_PREPARE:
        return {"type": "PREPARE", "b": _bt(p.ballot), "p": _bt(p.prepared),
                "pp": _bt(p.preparedPrime), "nC": p.nC, "nH": p.nH}
    if t == S.ST_CONFIRM:
        return {"type": "CONFIRM", "b": _bt(p.ballot), "nP": p.nPrepared,
                "nC": p.nCommit, "nH": p.nH}
    return {"type": "EXTERNALIZE", "c": _bt(p.commit), "nH": p.nH}


def _key(b: Optional[list]) -> Tuple:
    # None orders below every real ballot, like statement._opt
    return (-1, "") if b is None else (b[0], b[1])


def is_newer_summary(old: dict, new: dict) -> Optional[bool]:
    """Mirror of statement.is_newer_ballot_statement /
    is_newer_nomination over summaries.  Returns None for
    cross-protocol pairs (nomination vs ballot run as independent
    machines — they are never ordered against each other)."""
    o_nom, n_nom = old["type"] == "NOMINATE", new["type"] == "NOMINATE"
    if o_nom != n_nom:
        return None
    if n_nom:
        ov, nv = set(old["votes"]), set(new["votes"])
        oa, na = set(old["accepted"]), set(new["accepted"])
        if ov <= nv and oa <= na:
            return not (ov == nv and oa == na)
        return False
    to, tn = _BALLOT_RANK[old["type"]], _BALLOT_RANK[new["type"]]
    if to != tn:
        return to < tn
    if new["type"] == "EXTERNALIZE":
        return False
    if new["type"] == "CONFIRM":
        ob, nb = _key(old["b"]), _key(new["b"])
        if ob != nb:
            return ob < nb
        if old["nP"] != new["nP"]:
            return old["nP"] < new["nP"]
        return old["nH"] < new["nH"]
    ok = (_key(old["b"]), _key(old["p"]), _key(old["pp"]))
    nk = (_key(new["b"]), _key(new["p"]), _key(new["pp"]))
    if ok != nk:
        return ok < nk
    return old["nH"] < new["nH"]


def summaries_equivocate(a: dict, b: dict) -> bool:
    """Two statements from ONE node for ONE slot are equivocation
    evidence iff they are same-protocol, unequal, and neither is newer
    than the other — an honest emitter's statements are totally ordered
    (each emission strictly supersedes the last)."""
    if a == b:
        return False
    newer_ab = is_newer_summary(a, b)
    if newer_ab is None:
        return False
    return not newer_ab and not is_newer_summary(b, a)


class _SlotBuf:
    __slots__ = ("events", "dropped")

    def __init__(self, cap: int):
        self.events: deque = deque(maxlen=cap)
        self.dropped = 0


class SCPTimeline:
    """Bounded per-slot event ring.  One per SCP instance; disabled by
    default (a bare ``SCP()`` records nothing), the herder installs an
    enabled one wired to the app clock."""

    __slots__ = ("enabled", "max_slots", "per_slot", "_clock", "_slots",
                 "dropped_slots")

    def __init__(self, clock=None, enabled: bool = False,
                 max_slots: int = 32, per_slot: int = 256):
        self.enabled = enabled
        self.max_slots = max(1, int(max_slots))
        self.per_slot = max(8, int(per_slot))
        self._clock = clock
        self._slots: "OrderedDict[int, _SlotBuf]" = OrderedDict()
        self.dropped_slots = 0

    # -- recording (the ONLY consensus-side API) ---------------------------

    def record(self, slot_index: int, kind: str,
               fields: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        buf = self._slots.get(slot_index)
        if buf is None:
            buf = self._slots[slot_index] = _SlotBuf(self.per_slot)
            while len(self._slots) > self.max_slots:
                self._slots.popitem(last=False)
                self.dropped_slots += 1
        # the caller's dict IS the stored event (no copy): call sites
        # may keep mutating it with late fields — slot.py appends the
        # processing verdict to an "env" event recorded before the
        # processing it describes.  Still write-only: consensus code
        # never reads the dict back.
        ev = fields if fields is not None else {}
        ev["t"] = round(self._clock.now(), 6) \
            if self._clock is not None else 0.0
        ev["kind"] = kind
        if len(buf.events) == self.per_slot:
            buf.dropped += 1
        buf.events.append(ev)

    # -- export (observability side: HTTP / chaos aggregator / tools) -----

    def slots(self) -> List[int]:
        return sorted(self._slots)

    def export(self, slot_index: Optional[int] = None) -> dict:
        if slot_index is not None:
            buf = self._slots.get(slot_index)
            return {"slot": slot_index,
                    "recorded": buf is not None,
                    "dropped": buf.dropped if buf is not None else 0,
                    "events": [dict(e) for e in buf.events]
                    if buf is not None else []}
        return {
            "enabled": self.enabled,
            "max_slots": self.max_slots,
            "per_slot": self.per_slot,
            "dropped_slots": self.dropped_slots,
            "slots": {
                str(idx): {"dropped": buf.dropped,
                           "events": [dict(e) for e in buf.events]}
                for idx, buf in sorted(self._slots.items())},
        }


# ---------------------------------------------------------------------------
# cross-node analysis (pure functions over exports; used by the chaos
# forensic aggregator and its tests — never by consensus code)
# ---------------------------------------------------------------------------

def find_equivocations(timelines: Dict[str, dict]) -> List[dict]:
    """Scan merged per-node timeline exports for equivocation evidence.

    ``timelines`` maps a witness label (node hex8) to that node's
    ``SCPTimeline.export()``.  Every ``env`` event carries the origin
    node, a statement summary and a content fingerprint; two DISTINCT
    fingerprints from one (slot, origin, protocol) whose summaries are
    mutually unordered prove the origin emitted conflicting statements
    — honest emissions are totally ordered, so only a Byzantine node
    (or a forged signature, which SCP rejects upstream) can produce
    such a pair.  Rejected envelopes count as witness material too:
    the half that refused a twin still SAW it."""
    # (slot, origin, proto) -> fingerprint -> record
    groups: Dict[tuple, Dict[str, dict]] = {}
    for witness in sorted(timelines):
        doc = timelines[witness]
        for slot_str, slot_doc in sorted(doc.get("slots", {}).items()):
            for ev in slot_doc.get("events", []):
                if ev.get("kind") != "env" or "st" not in ev:
                    continue
                st = ev["st"]
                proto = "nom" if st["type"] == "NOMINATE" else "ballot"
                key = (int(slot_str), ev.get("from", "?"), proto)
                rec = groups.setdefault(key, {}).setdefault(
                    ev.get("fp", "?"),
                    {"fp": ev.get("fp", "?"), "summary": st,
                     "witnesses": set(), "t": ev.get("t", 0.0)})
                rec["witnesses"].add(witness)
                rec["t"] = min(rec["t"], ev.get("t", 0.0))
    out: List[dict] = []
    for (slot, origin, proto) in sorted(groups):
        recs = sorted(groups[(slot, origin, proto)].values(),
                      key=lambda r: (r["t"], r["fp"]))
        if len(recs) < 2:
            continue
        conflicting: List[dict] = []
        pairs = 0
        for i in range(len(recs)):
            for j in range(i + 1, len(recs)):
                if summaries_equivocate(recs[i]["summary"],
                                        recs[j]["summary"]):
                    pairs += 1
                    for r in (recs[i], recs[j]):
                        if r not in conflicting:
                            conflicting.append(r)
        if not pairs:
            continue
        out.append({
            "slot": slot,
            "node": origin,
            "proto": proto,
            "conflicting_pairs": pairs,
            "statements": [
                {"fp": r["fp"], "t": round(r["t"], 6),
                 "summary": r["summary"],
                 "witnesses": sorted(r["witnesses"])}
                for r in conflicting],
        })
    return out
