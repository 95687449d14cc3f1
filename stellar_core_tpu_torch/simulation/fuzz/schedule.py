"""Fault-schedule IR: a serializable chaos scenario, pure in one seed.

A schedule is plain JSON composing the chaos primitives (partition,
heal, crash/restore, lag, flaky links, Byzantine equivocation,
selective-forwarding silence, stale replay) with loadgen traffic
phases — exactly the vocabulary ``run_scenario`` executes, with node
references as INDICES into the topology's deterministic node order so
a schedule is meaningful without building a sim.

Everything the generator emits derives from one integer seed: the
topology (sampled from the core-N / tiered-org grid, up to the
100+-validator fleet), the event kinds, their times, victims and
parameters, and the traffic phases.  ``canonical_bytes`` is the
determinism contract's byte form: same seed => identical bytes
(asserted across PYTHONHASHSEED values by tests/test_fuzz_schedule.py).
"""
from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional

from ...crypto import sha256

SCHEMA_VERSION = 1

# repro/schedule files larger than this are rejected unparsed: a fuzz
# artifact is a few KB of events, never megabytes (oversized-input
# hardening mirrors fuzzing.py's XDR harness limits)
MAX_SCHEDULE_BYTES = 256 * 1024

EVENT_KINDS = ("partition", "heal", "flaky", "clear_links", "lag",
               "unlag", "crash", "restore", "equivocate", "silence",
               "capture_scp", "replay_stale")

TRAFFIC_MODES = ("pay", "pretend", "mixed")

# generation profiles: how big a network and how long a window the
# campaign budget affords (the fuzz smoke stays on the small grid; the
# bench's fleet profile reaches the 100-validator tier)
PROFILES = {
    "smoke": {"topologies": [
        {"kind": "core", "n": 4},
        {"kind": "tiered", "n_orgs": 3, "per_org": 3},
    ], "duration": (12.0, 18.0), "max_events": 4, "traffic_max": 1},
    "default": {"topologies": [
        {"kind": "core", "n": 4},
        {"kind": "core", "n": 7},
        {"kind": "tiered", "n_orgs": 3, "per_org": 3},
        {"kind": "tiered", "n_orgs": 5, "per_org": 4},
    ], "duration": (14.0, 22.0), "max_events": 6, "traffic_max": 2},
    "fleet": {"topologies": [
        {"kind": "tiered", "n_orgs": 10, "per_org": 5},
        {"kind": "tiered", "n_orgs": 20, "per_org": 5},
        {"kind": "tiered", "n_orgs": 25, "per_org": 4},
    ], "duration": (10.0, 14.0), "max_events": 4, "traffic_max": 1},
}


class ScheduleError(ValueError):
    """A schedule (or repro file) failed validation."""


# ---------------------------------------------------------------------------
# canonical form + persistence
# ---------------------------------------------------------------------------

def canonical_bytes(sched: dict) -> bytes:
    """The schedule's canonical byte form: sorted keys, minimal
    separators, trailing newline — byte-identical across processes and
    PYTHONHASHSEED values (json.dumps(sort_keys=True) is insertion-
    order-free)."""
    return (json.dumps(sched, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


def schedule_id(sched: dict) -> str:
    return sha256(canonical_bytes(sched)).hex()[:16]


def save_schedule(sched: dict, path: str) -> str:
    validate_schedule(sched)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(canonical_bytes(sched))
    return path


def load_schedule(path: str) -> dict:
    """Load + validate one schedule/repro file; corrupted or oversized
    inputs raise ``ScheduleError`` (never a raw parse traceback — the
    repro tool's operator sees WHAT was wrong with the file)."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise ScheduleError(f"unreadable schedule file: {e}") from None
    if size > MAX_SCHEDULE_BYTES:
        raise ScheduleError(
            f"oversized schedule file: {size} bytes > "
            f"{MAX_SCHEDULE_BYTES} cap")
    with open(path, "rb") as f:
        raw = f.read()
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ScheduleError(f"corrupted schedule file: {e}") from None
    sched = doc.get("schedule", doc) if isinstance(doc, dict) else doc
    validate_schedule(sched)
    return doc


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def topology_size(topo: dict) -> int:
    if topo["kind"] == "core":
        return int(topo["n"])
    return int(topo["n_orgs"]) * int(topo["per_org"])


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ScheduleError(what)


def validate_schedule(sched: dict) -> None:
    _check(isinstance(sched, dict), "schedule must be a JSON object")
    _check(sched.get("fuzz_schema") == SCHEMA_VERSION,
           f"unknown fuzz_schema {sched.get('fuzz_schema')!r} "
           f"(expected {SCHEMA_VERSION})")
    _check(isinstance(sched.get("seed"), int), "seed must be an int")
    topo = sched.get("topology")
    _check(isinstance(topo, dict), "topology must be an object")
    kind = topo.get("kind")
    _check(kind in ("core", "tiered"), f"unknown topology kind {kind!r}")
    if kind == "core":
        _check(isinstance(topo.get("n"), int) and 2 <= topo["n"] <= 256,
               "core topology needs 2 <= n <= 256")
        thr = topo.get("threshold")
        _check(thr is None or (isinstance(thr, int)
                               and 1 <= thr <= topo["n"]),
               "core threshold out of range")
    else:
        _check(isinstance(topo.get("n_orgs"), int)
               and isinstance(topo.get("per_org"), int)
               and 2 <= topo["n_orgs"] <= 64
               and 1 <= topo["per_org"] <= 16,
               "tiered topology needs 2<=n_orgs<=64, 1<=per_org<=16")
    n = topology_size(topo)
    dur = sched.get("duration")
    _check(isinstance(dur, (int, float)) and 1.0 <= dur <= 600.0,
           "duration must be 1..600 virtual seconds")
    ct = sched.get("converge_timeout", 120.0)
    _check(isinstance(ct, (int, float)) and 1.0 <= ct <= 600.0,
           "converge_timeout must be 1..600 virtual seconds")

    def _idx(v, what):
        _check(isinstance(v, int) and 0 <= v < n,
               f"{what}: node index {v!r} out of range 0..{n - 1}")

    events = sched.get("events", [])
    _check(isinstance(events, list) and len(events) <= 64,
           "events must be a list of at most 64 entries")
    for ev in events:
        _check(isinstance(ev, dict), "event must be an object")
        _check(ev.get("kind") in EVENT_KINDS,
               f"unknown event kind {ev.get('kind')!r}")
        t = ev.get("t")
        _check(isinstance(t, (int, float)) and 0.0 <= t <= dur,
               f"event time {t!r} outside 0..duration")
        kind = ev["kind"]
        if kind == "partition":
            groups = ev.get("groups")
            _check(isinstance(groups, list) and len(groups) >= 2,
                   "partition needs >= 2 groups")
            seen: set = set()
            for g in groups:
                _check(isinstance(g, list) and g, "empty partition group")
                for v in g:
                    _idx(v, "partition")
                    _check(v not in seen,
                           f"node {v} in two partition groups")
                    seen.add(v)
        elif kind == "flaky":
            for v in ev.get("victims", []):
                _idx(v, "flaky")
            for p in ("drop", "damage", "duplicate"):
                x = ev.get(p, 0.0)
                _check(isinstance(x, (int, float)) and 0.0 <= x <= 1.0,
                       f"flaky {p} must be a probability")
        elif kind in ("lag", "unlag", "crash", "restore", "equivocate",
                      "silence", "capture_scp"):
            _idx(ev.get("victim"), kind)
            if kind == "lag":
                lat = ev.get("latency", 1.0)
                _check(isinstance(lat, (int, float))
                       and 0.0 <= lat <= 30.0,
                       "lag latency must be 0..30s")
        elif kind == "replay_stale":
            _idx(ev.get("attacker"), kind)
            age = ev.get("age", 2)
            _check(isinstance(age, int) and 1 <= age <= 1000,
                   "replay_stale age must be 1..1000 slots")

    traffic = sched.get("traffic", [])
    _check(isinstance(traffic, list) and len(traffic) <= 8,
           "traffic must be a list of at most 8 phases")
    prev_end = None
    for p in sorted(traffic, key=lambda p: p.get("t", 0.0)):
        _check(isinstance(p, dict), "traffic phase must be an object")
        _check(p.get("mode", "pay") in TRAFFIC_MODES,
               f"unknown traffic mode {p.get('mode')!r}")
        t, d = p.get("t"), p.get("duration")
        _check(isinstance(t, (int, float)) and 0.0 <= t <= dur,
               "traffic phase start outside 0..duration")
        _check(isinstance(d, (int, float)) and 0.5 <= d <= dur,
               "traffic phase duration out of range")
        rate = p.get("rate")
        _check(isinstance(rate, (int, float)) and 0.0 < rate <= 1000.0,
               "traffic rate must be 0..1000 tx/s")
        if prev_end is not None:
            _check(t >= prev_end, "overlapping traffic phases")
        prev_end = t + d


# ---------------------------------------------------------------------------
# topology resolution
# ---------------------------------------------------------------------------

def node_ids(topo: dict) -> List[bytes]:
    """The topology's node ids WITHOUT building a sim (ids are a pure
    function of the node index — simulation._seeds)."""
    from ..simulation import _ids, _seeds

    return _ids(_seeds(topology_size(topo)))


def topology_factory(topo: dict, persist_dir: Optional[str],
                     device=None, **config_kw) -> Callable:
    """make_sim() for one schedule's topology.  Consensus must free-run
    (MANUAL_CLOSE=False) for schedules to mean anything.  ``device`` and
    ``config_kw`` (the nodes' backends) go to every node: on the default
    backends the network runs its device tiers on the GPU unless
    ``device`` names another."""
    from ..simulation import core, hierarchical_quorum

    if topo["kind"] == "core":
        return lambda: core(
            int(topo["n"]), threshold=topo.get("threshold"),
            persist_dir=persist_dir, device=device, MANUAL_CLOSE=False,
            **config_kw)
    return lambda: hierarchical_quorum(
        int(topo["n_orgs"]), int(topo["per_org"]),
        persist_dir=persist_dir, device=device, MANUAL_CLOSE=False,
        **config_kw)


# ---------------------------------------------------------------------------
# the seeded generator
# ---------------------------------------------------------------------------

def _rng_for(seed: int) -> random.Random:
    return random.Random(int.from_bytes(
        sha256(b"fuzz-schedule-%d" % seed), "big"))


def generate_schedule(seed: int, profile: str = "default") -> dict:
    """One schedule, pure in ``seed``: every choice below draws from a
    seed-derived RNG and nothing else.  Generated schedules are meant
    to PASS on healthy topologies — the fuzzer's job is to find the
    interleaving where the implementation breaks its own oracles, not
    to script guaranteed forks (that's ``known_bad_schedule``)."""
    prof = PROFILES[profile]
    rng = _rng_for(seed)
    topo = dict(rng.choice(prof["topologies"]))
    n = topology_size(topo)
    duration = round(rng.uniform(*prof["duration"]), 1)
    ids = list(range(n))

    events: List[dict] = []
    crashed: set = set()
    n_events = rng.randint(1, prof["max_events"])
    # event times leave the first 2s for the network to start closing
    # and the last 3s for late faults to bite before the heal epilogue
    times = sorted(round(rng.uniform(2.0, max(3.0, duration - 3.0)), 1)
                   for _ in range(n_events))
    for t in times:
        kind = rng.choice(
            ("partition", "flaky", "lag", "crash", "equivocate",
             "replay_chain", "clear_links", "heal"))
        if kind == "partition":
            cut = rng.sample(ids, max(1, n // 3))
            keep = [i for i in ids if i not in cut]
            events.append({"t": t, "kind": "partition",
                           "groups": [keep, cut]})
            if rng.random() < 0.7:
                events.append({
                    "t": round(min(duration,
                                   t + rng.uniform(3.0, 8.0)), 1),
                    "kind": "heal"})
        elif kind == "flaky":
            events.append({
                "t": t, "kind": "flaky",
                "victims": sorted(rng.sample(ids, max(1, n // 4))),
                "drop": round(rng.uniform(0.01, 0.05), 3),
                "damage": round(rng.uniform(0.0, 0.02), 3),
                "duplicate": round(rng.uniform(0.0, 0.02), 3)})
            if rng.random() < 0.7:
                events.append({
                    "t": round(min(duration,
                                   t + rng.uniform(3.0, 8.0)), 1),
                    "kind": "clear_links"})
        elif kind == "lag":
            v = rng.choice(ids)
            events.append({"t": t, "kind": "lag", "victim": v,
                           "latency": round(rng.uniform(0.5, 3.0), 2)})
            if rng.random() < 0.7:
                events.append({
                    "t": round(min(duration,
                                   t + rng.uniform(3.0, 8.0)), 1),
                    "kind": "unlag", "victim": v})
        elif kind == "crash" and len(crashed) < max(1, (n - 1) // 3):
            v = rng.choice([i for i in ids if i not in crashed])
            crashed.add(v)
            events.append({"t": t, "kind": "crash", "victim": v})
            if rng.random() < 0.7:
                events.append({
                    "t": round(min(duration,
                                   t + rng.uniform(4.0, 9.0)), 1),
                    "kind": "restore", "victim": v})
                crashed.discard(v)
        elif kind == "equivocate":
            # Byzantine minority only: the generator probes the honest
            # majority's tolerance, never scripts an unsafe quorum
            byz = rng.sample(ids, max(1, (n - 1) // 4))
            for v in byz:
                events.append({"t": t, "kind": "equivocate",
                               "victim": v})
        elif kind == "replay_chain":
            a = rng.choice(ids)
            events.append({"t": min(t, 1.0), "kind": "capture_scp",
                           "victim": a})
            events.append({
                "t": round(max(t, min(duration - 1.0, 14.0)), 1),
                "kind": "replay_stale", "attacker": a,
                "age": rng.randint(2, 4),
                "limit": rng.randint(16, 64)})
        elif kind == "clear_links":
            events.append({"t": t, "kind": "clear_links"})
        elif kind == "heal":
            events.append({"t": t, "kind": "heal"})

    traffic: List[dict] = []
    if prof["traffic_max"] and rng.random() < 0.75:
        t_cursor = round(rng.uniform(0.5, 2.0), 1)
        for _ in range(rng.randint(1, prof["traffic_max"])):
            d = round(rng.uniform(4.0, min(8.0, duration - 2.0)), 1)
            if t_cursor + d > duration:
                break
            traffic.append({
                "t": t_cursor, "duration": d,
                "mode": rng.choice(("pay", "pay", "pretend", "mixed")),
                "rate": round(rng.uniform(2.0, 8.0), 1),
                "dex_percent": rng.choice((30, 50))})
            t_cursor = round(t_cursor + d + rng.uniform(0.5, 2.0), 1)

    # canonical event order: by time, then kind (stable across reruns)
    events.sort(key=lambda e: (e["t"], e["kind"]))
    sched = {
        "fuzz_schema": SCHEMA_VERSION,
        "seed": seed,
        "profile": profile,
        "topology": topo,
        "duration": duration,
        "converge_timeout": 150.0 if topology_size(topo) >= 50 else 90.0,
        "events": events,
        "traffic": traffic,
    }
    validate_schedule(sched)
    return sched


def known_bad_schedule(seed: int = 14, noise: bool = True) -> dict:
    """The injected known-bad: a deliberately-unsafe core-4 (threshold
    2 — sub-intersecting quorums, the ``run_induced_fork`` recipe as
    IR) where one node equivocates, relays nothing (silence), and the
    honest nodes are partitioned around it.  Those three events
    deterministically fork the network; the ``noise`` events are
    harmless chaff the ddmin minimizer must strip away."""
    essential = [
        {"t": 2.0, "kind": "equivocate", "victim": 1},
        {"t": 2.0, "kind": "silence", "victim": 1},
        {"t": 3.0, "kind": "partition", "groups": [[2], [0, 3]]},
    ]
    chaff = [
        {"t": 4.0, "kind": "lag", "victim": 3, "latency": 0.4},
        {"t": 6.0, "kind": "unlag", "victim": 3},
        {"t": 5.0, "kind": "flaky", "victims": [0], "drop": 0.01,
         "damage": 0.0, "duplicate": 0.01},
        {"t": 7.0, "kind": "clear_links"},
    ] if noise else []
    events = sorted(essential + chaff,
                    key=lambda e: (e["t"], e["kind"]))
    sched = {
        "fuzz_schema": SCHEMA_VERSION,
        "seed": seed,
        "profile": "known-bad",
        "topology": {"kind": "core", "n": 4, "threshold": 2},
        "duration": 16.0,
        "converge_timeout": 30.0,
        "events": events,
        "traffic": [],
    }
    validate_schedule(sched)
    return sched
