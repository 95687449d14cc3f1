"""Chaos engine: deterministic fault injection over simulated networks.

Everything here is driven by ONE chaos seed: per-link fault RNGs derive
from it (sha256(seed || endpoints || epoch)), scenario event times are
virtual-clock timers, and Byzantine behavior is scripted — so a chaos
run is a pure function of (topology, scenario, seed) and re-running it
reproduces the exact same per-node ledger-hash sequences.  That
determinism is itself asserted (``fingerprint`` + the seed-determinism
tests): a heisen-failure under chaos would be worthless evidence.

Fault taxonomy (ref the reference's LoopbackPeer damage knobs +
Simulation-based HerderTests, scaled into scripted scenarios):

- **link faults** — per-direction drop/damage/duplicate probabilities
  and latency on loopback links (``LinkChaos`` in overlay/peer.py).
  Drop/damage/duplicate break the authenticated MAC sequence exactly
  like a torn TCP stream, so connections die and the engine's link
  maintenance re-dials them (connection churn is part of the chaos).
- **partitions** — ``partition(groups)`` cuts every link crossing group
  boundaries (total deterministic loss, counted ``overlay.chaos.cut``);
  ``heal()`` restores wiring and starts the time-to-heal stopwatch.
- **crash / kill-restore** — ``crash(node)`` tears the Application down
  mid-flight (shared clock survives, on-disk state survives);
  ``restore(node)`` rebuilds from disk via the restart-from-state path
  and re-wires its topology links.
- **laggards** — ``lag(node, seconds)`` adds symmetric latency to every
  link of one node.
- **Byzantine actors** — ``equivocate(node)`` wraps a captured
  validator's broadcast so every SCP emission is accompanied by a
  conflicting variant (same slot, same txSetHash, bumped closeTime)
  signed with the node's real key, sent to disjoint halves of its
  peers; ``replay_stale(attacker, ...)`` re-floods envelopes captured
  rounds ago (honest nodes must discard them via the herder's slot
  bracket, not re-grow SCP state).

Safety oracle after every scenario: zero forks among honest survivors
(header-chain AND bucket-hash agreement via ``Simulation.assert_no_forks``),
no invariant violations (sim nodes run ``INVARIANT_CHECKS=[".*"]`` — a
violation crashes the close and therefore the scenario), and liveness:
the surviving quorum kept closing and the network converged after the
faults cleared (``time_to_heal``).
"""
from __future__ import annotations

import json
import os
import random
import time as _wall
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto import sha256
from ..overlay.peer import LinkChaos, PeerState
from ..utils.clock import VirtualTimer
from ..xdr import overlay_types as O
from ..xdr import types as T
from .simulation import Simulation


class ScenarioFailure(AssertionError):
    """Typed oracle failure raised by ``run_scenario``.

    ``failure_class`` names WHICH oracle tripped (``fork``,
    ``convergence-timeout``, ``unfired-script``, ``traffic``) — the
    fuzzer's ddmin minimizer shrinks against the CLASS (same oracle
    keeps failing) while the full failure fingerprint stays the
    replay-identity check for the persisted repro."""

    def __init__(self, failure_class: str, message: str,
                 forensics_path: Optional[str] = None):
        super().__init__(message)
        self.failure_class = failure_class
        self.forensics_path = forensics_path


class LinkPolicy:
    """The engine's intended fault state for one (a, b) link; re-applied
    whenever link maintenance re-dials the pair."""

    __slots__ = ("drop", "damage", "duplicate", "latency", "cut")

    def __init__(self):
        self.drop = 0.0
        self.damage = 0.0
        self.duplicate = 0.0
        self.latency = 0.0
        self.cut = False

    def active(self) -> bool:
        return bool(self.cut or self.drop or self.damage
                    or self.duplicate or self.latency)


class ChaosEngine:
    """Seeded fault scheduler over one ``Simulation``."""

    MAINTENANCE_PERIOD = 1.0  # virtual seconds between re-dial sweeps

    def __init__(self, sim: Simulation, seed: int):
        self.sim = sim
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.byzantine: set = set()
        self.policies: Dict[Tuple[bytes, bytes], LinkPolicy] = {}
        self._link_epoch: Dict[Tuple[bytes, bytes], int] = {}
        self.reconnects = 0
        self.equivocations = 0
        self.replayed = 0
        self.events: List[Tuple[float, str]] = []
        # node -> seq -> (virtual time, wall time) of local externalize
        self.extern_times: Dict[bytes, Dict[int, Tuple[float, float]]] = {}
        # node -> seq -> header hash at externalize (the live fork/
        # determinism record; the DB header chain is the post-hoc oracle)
        self.extern_hashes: Dict[bytes, Dict[int, bytes]] = {}
        self._capture: List = []  # (slot, envelope) log for stale replay
        self._timers: List[VirtualTimer] = []
        self._maint_timer: Optional[VirtualTimer] = None
        # virtual time the last fault was cleared (heal/unlag/restore) —
        # the time-to-heal stopwatch's zero
        self.last_clear_time: float = sim.clock.now()
        for nid in sim.nodes:
            self._hook_node(nid)

    # -- bookkeeping ---------------------------------------------------------

    def log_event(self, what: str) -> None:
        self.events.append((round(self.sim.clock.now(), 3), what))

    def _hook_node(self, nid: bytes) -> None:
        app = self.sim.nodes[nid]
        times = self.extern_times.setdefault(nid, {})
        hashes = self.extern_hashes.setdefault(nid, {})

        def on_ext(slot, sv, app=app, times=times, hashes=hashes):
            lm = app.ledger_manager
            if lm.last_closed_seq() >= slot:
                times.setdefault(
                    slot, (self.sim.clock.now(), _wall.monotonic()))
                if lm.last_closed_seq() == slot:
                    hashes.setdefault(slot, lm.last_closed_hash())

        app.herder.on_externalized.append(on_ext)

    def _link_rng(self, a: bytes, b: bytes) -> random.Random:
        epoch = self._link_epoch.get((a, b), 0)
        self._link_epoch[(a, b)] = epoch + 1
        material = sha256(b"chaos-link-%d-%d" % (self.seed, epoch) + a + b)
        return random.Random(int.from_bytes(material, "big"))

    def _key(self, a: bytes, b: bytes) -> Tuple[bytes, bytes]:
        """Canonical (a, b) orientation: the one the topology recorded."""
        return (b, a) if (b, a) in self.sim.topology else (a, b)

    def _policy(self, a: bytes, b: bytes) -> LinkPolicy:
        return self.policies.setdefault(self._key(a, b), LinkPolicy())

    def _apply_policy(self, key: Tuple[bytes, bytes]) -> None:
        policy = self.policies.get(key)
        for peer in self.sim.link_peers(*key):
            if policy is None or not policy.active():
                peer.set_chaos(None)
                continue
            a, b = key
            peer.set_chaos(LinkChaos(
                self._link_rng(a, b), drop=policy.drop,
                damage=policy.damage, duplicate=policy.duplicate,
                latency=policy.latency, cut=policy.cut))

    # -- link faults ---------------------------------------------------------

    def set_link(self, a: bytes, b: bytes, drop: float = 0.0,
                 damage: float = 0.0, duplicate: float = 0.0,
                 latency: float = 0.0, cut: Optional[bool] = None) -> None:
        policy = self._policy(a, b)
        policy.drop = drop
        policy.damage = damage
        policy.duplicate = duplicate
        policy.latency = latency
        if cut is not None:
            policy.cut = cut
        self._apply_policy(self._key(a, b))

    def clear_links(self) -> None:
        """Drop every probabilistic fault and latency; cuts (partitions)
        persist until ``heal``."""
        for key, policy in self.policies.items():
            policy.drop = policy.damage = policy.duplicate = 0.0
            policy.latency = 0.0
            self._apply_policy(key)
        self.last_clear_time = self.sim.clock.now()
        self.log_event("links cleared")

    def partition(self, groups: List[List[bytes]]) -> None:
        """Cut every link whose endpoints land in different groups (nodes
        in no group keep all their links)."""
        side = {}
        for gi, group in enumerate(groups):
            for nid in group:
                side[nid] = gi
        n_cut = 0
        for a, b in self.sim.topology:
            if a in side and b in side and side[a] != side[b]:
                policy = self._policy(a, b)
                if not policy.cut:
                    policy.cut = True
                    n_cut += 1
                self._apply_policy(self._key(a, b))
        self.log_event(f"partition: {len(groups)} groups, {n_cut} links cut")

    def heal(self) -> None:
        for key, policy in self.policies.items():
            policy.cut = False
            self._apply_policy(key)
        self.last_clear_time = self.sim.clock.now()
        self.log_event("heal")

    def lag(self, nid: bytes, latency: float) -> None:
        for a, b in self.sim.topology:
            if nid in (a, b):
                policy = self._policy(a, b)
                policy.latency = latency
                self._apply_policy(self._key(a, b))
        if latency:
            self.log_event(f"lag {nid.hex()[:8]} by {latency}s")
        else:
            self.last_clear_time = self.sim.clock.now()
            self.log_event(f"unlag {nid.hex()[:8]}")

    # -- crash / restore -----------------------------------------------------

    def crash(self, nid: bytes) -> None:
        self.sim.crash_node(nid)
        self.log_event(f"crash {nid.hex()[:8]}")

    def restore(self, nid: bytes) -> None:
        self.sim.restart_node(nid)
        self._hook_node(nid)
        for key in self.policies:
            if nid in key:
                self._apply_policy(key)
        self.last_clear_time = self.sim.clock.now()
        self.log_event(f"restore {nid.hex()[:8]}")

    # -- link maintenance (reconnect churn) ---------------------------------

    def start_maintenance(self) -> None:
        """Periodically re-dial topology links whose connection died —
        drop/damage/duplicate faults break the authenticated MAC stream
        by design, so sustained probabilistic chaos NEEDS reconnection
        for the network to stay live (the churn is part of the test)."""
        if self._maint_timer is None:
            self._maint_timer = VirtualTimer(self.sim.clock, owner=self)
        self._arm_maintenance()

    def _arm_maintenance(self) -> None:
        t = self._maint_timer
        t.cancel()
        t.expires_from_now(self.MAINTENANCE_PERIOD)
        t.async_wait(self._maintain_links)

    def _maintain_links(self) -> None:
        self.maintain_links_once()
        self._arm_maintenance()

    def maintain_links_once(self) -> int:
        sim = self.sim
        redialed = 0
        for a, b in sim.topology:
            if sim.crashed.get(a) or sim.crashed.get(b):
                continue
            peers = sim.link_peers(a, b)
            dead = not peers or any(
                p.state == PeerState.CLOSING for p in peers)
            if not dead:
                continue
            for p in peers:
                if p.state != PeerState.CLOSING:
                    p.close("chaos re-dial")
            sim.links.pop((a, b), None)
            sim.links.pop((b, a), None)
            sim._wire(a, b)
            key = (a, b) if (a, b) in self.policies else (b, a)
            if key in self.policies:
                self._apply_policy(key)
            redialed += 1
        self.reconnects += redialed
        return redialed

    def stop(self) -> None:
        if self._maint_timer is not None:
            self._maint_timer.cancel()
        for t in self._timers:
            t.cancel()
        self.sim.clock.cancel_owner(self)

    # -- Byzantine actors ----------------------------------------------------

    def equivocate(self, nid: bytes) -> None:
        """Turn ``nid`` into an equivocator: every SCP emission goes out
        in two conflicting variants (original + closeTime-bumped value,
        both properly signed) to disjoint halves of its peers, bypassing
        the floodgate so the halves really do see different statements.
        Honest forwarding then spreads both network-wide."""
        app = self.sim.nodes[nid]
        self.byzantine.add(nid)
        engine = self

        def equivocating_broadcast(env, app=app):
            alt = engine._perturb_envelope(app, env)
            peers = sorted(app.overlay_manager.authenticated.values(),
                           key=lambda p: p.peer_id or b"")
            if alt is not None:
                engine.equivocations += 1
            for i, p in enumerate(peers):
                send = env if (alt is None or i % 2 == 0) else alt
                p.send_message(O.StellarMessage.make(
                    O.MessageType.SCP_MESSAGE, send))

        app.broadcast_scp_message = equivocating_broadcast
        self.log_event(f"equivocator {nid.hex()[:8]}")

    def _sign_statement(self, app, st):
        """Properly-signed envelope for a forged statement — through the
        node's OWN driver (the equivocator holds its real key), so the
        signed-body format lives in exactly one place."""
        env = T.SCPEnvelope.make(statement=st, signature=b"")
        app.herder.driver.sign_envelope(env)
        return env

    @staticmethod
    def _bump_value(value: bytes) -> Optional[bytes]:
        """A conflicting-but-valid variant of one consensus value: same
        tx set, closeTime+1 — passes every honest validity check while
        differing as a ballot/nomination value."""
        try:
            sv = T.StellarValue.decode(value)
        except Exception:
            return None
        return T.StellarValue.encode(sv._replace(closeTime=sv.closeTime + 1))

    def _perturb_envelope(self, app, env):
        """Build the conflicting twin of one emitted envelope (fresh
        statement + fresh signature; the original is never mutated)."""
        st = env.statement
        ST = T.SCPStatementType
        p = st.pledges
        try:
            if p.type == ST.SCP_ST_NOMINATE:
                nom = p.value
                votes = [self._bump_value(v) or v for v in nom.votes]
                accepted = [self._bump_value(v) or v
                            for v in nom.accepted]
                if votes == list(nom.votes) and \
                        accepted == list(nom.accepted):
                    return None
                pledges = T.SCPStatement.fields[2][1].make(
                    ST.SCP_ST_NOMINATE,
                    nom._replace(votes=votes, accepted=accepted))
            elif p.type == ST.SCP_ST_PREPARE:
                prep = p.value
                alt = self._bump_value(prep.ballot.value)
                if alt is None:
                    return None
                pledges = T.SCPStatement.fields[2][1].make(
                    ST.SCP_ST_PREPARE,
                    prep._replace(ballot=prep.ballot._replace(value=alt)))
            else:
                # CONFIRM/EXTERNALIZE equivocation would require the
                # node to have (claimed to have) accepted two commits —
                # emit a conflicting PREPARE-stage history instead by
                # leaving these untouched; nomination/prepare
                # equivocation is where split views are seeded
                return None
        except Exception:
            return None
        return self._sign_statement(
            app, st._replace(pledges=pledges))

    # -- stale replay --------------------------------------------------------

    def capture_scp(self, nid: bytes) -> None:
        """Record every envelope ``nid`` broadcasts (still delivering it
        normally) as future stale-replay ammunition."""
        app = self.sim.nodes[nid]
        orig = app.broadcast_scp_message
        engine = self

        def capturing_broadcast(env, orig=orig):
            engine._capture.append((env.statement.slotIndex, env))
            orig(env)

        app.broadcast_scp_message = capturing_broadcast

    def replay_stale(self, attacker: bytes, max_age_slot: int,
                     limit: int = 64) -> int:
        """Re-flood captured envelopes for slots <= ``max_age_slot`` from
        ``attacker``'s connections.  Honest nodes must shed them (herder
        slot bracket / floodgate) without re-growing SCP slot state."""
        app = self.sim.nodes[attacker]
        peers = sorted(app.overlay_manager.authenticated.values(),
                       key=lambda p: p.peer_id or b"")
        sent = 0
        for slot, env in self._capture:
            if slot > max_age_slot or sent >= limit:
                continue
            for p in peers:
                p.send_message(O.StellarMessage.make(
                    O.MessageType.SCP_MESSAGE, env))
            sent += 1
        self.replayed += sent
        self.log_event(f"stale replay: {sent} envelopes from "
                       f"{attacker.hex()[:8]}")
        return sent

    # -- aggregate counters --------------------------------------------------

    def chaos_counters(self) -> Dict[str, int]:
        out = {"dropped": 0, "damaged": 0, "duplicated": 0, "delayed": 0,
               "cut": 0}
        for app in self.sim.alive_nodes().values():
            for k in out:
                out[k] += app.metrics.counter(f"overlay.chaos.{k}").count
        out["reconnects"] = self.reconnects
        out["equivocations"] = self.equivocations
        out["stale_replayed"] = self.replayed
        out["stale_discarded"] = sum(
            app.metrics.counter("herder.scp.discarded").count
            for app in self.sim.alive_nodes().values())
        return out

    def honest_alive(self) -> List[bytes]:
        return [nid for nid in self.sim.alive_nodes()
                if nid not in self.byzantine]

    def fingerprint(self) -> str:
        """One hash over every honest node's externalized (seq, header
        hash) sequence — the chaos-seed determinism contract: the same
        (topology, scenario, seed) must reproduce this byte-for-byte."""
        h = sha256(b"".join(
            nid + seq.to_bytes(8, "big") + self.extern_hashes[nid][seq]
            for nid in sorted(self.honest_alive())
            for seq in sorted(self.extern_hashes.get(nid, {}))))
        return h.hex()


# ---------------------------------------------------------------------------
# network-wide forensic aggregator (ISSUE 14 tentpole part 4)
# ---------------------------------------------------------------------------

def first_hash_divergence(chaos: ChaosEngine) -> Optional[dict]:
    """First slot where two honest nodes externalized different header
    hashes — the fork's ground zero (None while no divergence)."""
    honest = sorted(chaos.honest_alive())
    seqs = sorted({s for n in honest
                   for s in chaos.extern_hashes.get(n, {})})
    for s in seqs:
        by_hash: Dict[str, List[str]] = {}
        for n in honest:
            h = chaos.extern_hashes.get(n, {}).get(s)
            if h is not None:
                by_hash.setdefault(h.hex()[:16], []).append(n.hex()[:8])
        if len(by_hash) > 1:
            return {"slot": s, "nodes": dict(sorted(by_hash.items()))}
    return None


def collect_forensics(sim: Simulation, chaos: ChaosEngine, label: str,
                      seed: int, reason: str) -> dict:
    """Merge every alive node's SCP timeline into one cross-node
    forensic record with first-divergence attribution: which node,
    which slot, which message.

    Attribution order: equivocation evidence (two mutually-unordered
    statements from one node for one slot, found by
    scp/timeline.find_equivocations over the merged exports) beats the
    raw externalized-hash divergence — the hash split is the SYMPTOM,
    the conflicting statement pair is the CAUSE and names its emitter.
    Everything here is a pure function of sim state and virtual time,
    so a same-seed rerun reproduces the dump byte-for-byte."""
    from ..scp.timeline import find_equivocations

    timelines = {}
    for nid in sorted(sim.alive_nodes()):
        app = sim.nodes[nid]
        timelines[nid.hex()[:8]] = app.herder.scp.timeline.export()
    extern = {
        nid.hex()[:8]: {str(s): h.hex()
                        for s, h in sorted(
                            chaos.extern_hashes.get(nid, {}).items())}
        for nid in sorted(chaos.extern_hashes)}
    divergence = first_hash_divergence(chaos)
    equivocations = find_equivocations(timelines)
    first: Optional[dict] = None
    if equivocations:
        e = equivocations[0]  # already sorted by (slot, node)
        first = {"via": "equivocation", "slot": e["slot"],
                 "node": e["node"],
                 "message": {"proto": e["proto"],
                             "statements": e["statements"]}}
    elif divergence is not None:
        first = {"via": "externalized-hash",
                 "slot": divergence["slot"],
                 "node": divergence["nodes"], "message": None}
    return {
        "forensics_schema": 1,
        "scenario": label,
        "seed": seed,
        "reason": reason,
        "nodes": {
            "honest": sorted(n.hex()[:8] for n in chaos.honest_alive()),
            "byzantine": sorted(n.hex()[:8] for n in chaos.byzantine),
            "crashed": sorted(n.hex()[:8] for n, dead
                              in sim.crashed.items() if dead)},
        "first_divergence": first,
        "divergence": divergence,
        "equivocations": equivocations,
        "per_node_externalized": extern,
        "chaos_events": [list(e) for e in chaos.events],
        "timelines": timelines,
    }


def dump_forensics(report: dict, out_dir: Optional[str] = None) -> str:
    """Persist one forensic record as FORENSICS_<scenario>_seed<N>.json
    (sorted keys, trailing newline — byte-identical across same-seed
    reruns)."""
    out_dir = out_dir or os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"FORENSICS_{report['scenario']}_seed"
                 f"{report['seed']}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def run_induced_fork(make_sim: Callable[[], Simulation], seed: int,
                     duration: float = 60.0,
                     forensics_dir: Optional[str] = None) -> tuple:
    """Deliberately fork a deliberately-unsafe network and prove the
    forensics name the culprit: one equivocating Byzantine node on a
    sub-intersecting quorum (e.g. core-4 at threshold 2, where
    {victim, byzantine} is a full quorum) splits honest nodes onto
    conflicting values.  EXPECTS the fork: raises if none happens
    within ``duration`` virtual seconds; otherwise dumps the merged
    forensic record and returns (report, dump_path).

    This is the verify_green forensic smoke's engine: the dump's
    first_divergence must identify the equivocator and the forked
    slot, and a same-seed rerun must reproduce the dump bytes."""
    sim = make_sim()
    chaos = ChaosEngine(sim, seed)
    sim.start_all_nodes()
    while sim.crank():
        pass
    chaos.start_maintenance()
    rng = random.Random(int.from_bytes(
        sha256(b"induced-fork-%d" % seed), "big"))
    ids = sorted(sim.nodes)
    byz = rng.choice(ids)
    honest = [n for n in ids if n != byz]
    # the full Byzantine bridge: the node equivocates to its peers,
    # relays NOTHING across them (selective forwarding), and the
    # honest nodes are partitioned around it — each side can only
    # reach quorum WITH the bridge, on the bridge's conflicting values
    chaos.equivocate(byz)
    sim.nodes[byz].overlay_manager.broadcast_message = \
        lambda *a, **kw: None
    chaos.partition([[honest[0]], honest[1:]])
    clock = sim.clock
    t_end = clock.now() + duration
    div = None
    seen_externs = -1
    while clock.now() < t_end:
        if clock.crank(block=True) == 0 and \
                clock.next_deadline() is None:
            break
        n_ext = sum(len(v) for v in chaos.extern_hashes.values())
        if n_ext != seen_externs:
            seen_externs = n_ext
            div = first_hash_divergence(chaos)
            if div is not None:
                break
    chaos.stop()
    try:
        if div is None:
            raise AssertionError(
                f"induced-fork seed {seed}: no honest divergence within "
                f"{duration}s virtual — the unsafe quorum never split")
        rep = collect_forensics(
            sim, chaos, "induced_fork", seed,
            reason=f"scripted fork probe: header divergence at slot "
                   f"{div['slot']}")
        path = dump_forensics(rep, forensics_dir)
    finally:
        for nid in list(sim.alive_nodes()):
            sim.nodes[nid].stop_node()
    return rep, path


# ---------------------------------------------------------------------------
# scenario runner
# ---------------------------------------------------------------------------

def _percentiles(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"p50": 0.0, "p99": 0.0, "max": 0.0}
    vs = sorted(values)

    def pct(p: float) -> float:
        i = min(len(vs) - 1, int(p * (len(vs) - 1) + 0.5))
        return vs[i]

    return {"p50": round(pct(0.50), 3), "p99": round(pct(0.99), 3),
            "max": round(vs[-1], 3)}


def _arm_traffic(sim: Simulation, chaos: ChaosEngine, traffic: List[dict],
                 events: List[tuple], phase_reports: List[dict],
                 label: str) -> tuple:
    """Seed loadgen accounts THROUGH consensus, then append each
    traffic phase to the scenario's event script (so phases share the
    unfired-script oracle and the chaos event log with every other
    fault).  Returns (LoadGenerator, merged events)."""
    from ..ledger.ledger_txn import LedgerTxn
    from .load_generator import LoadGenerator

    phases = sorted(traffic, key=lambda p: p["t"])
    prev_end = None
    for p in phases:
        assert p.get("mode", "pay") in ("pay", "pretend", "mixed"), p
        if prev_end is not None:
            assert p["t"] >= prev_end, \
                f"[{label}] overlapping traffic phases: {phases}"
        prev_end = p["t"] + p["duration"]

    assert sim.crank_until(lambda: sim.have_all_externalized(2), 120.0), \
        f"[{label}] network never started closing before traffic seeding"
    app0 = sim.nodes[sorted(sim.nodes)[0]]
    lg = LoadGenerator(app0)
    n_accounts = max(8, max(int(p.get("accounts", 0)) for p in phases))
    for env in lg.create_account_envelopes(n_accounts):
        assert app0.herder.recv_transaction(env) == 0

    def _applied(pub):
        def probe():
            with LedgerTxn(app0.ledger_manager.root) as ltx:
                e = ltx.load_account(pub)
                ltx.rollback()
            return e is not None
        return probe

    assert sim.crank_until(
        _applied(lg.accounts[-1].public_key().raw), 120.0), \
        f"[{label}] loadgen account seeding stalled"

    if any(p.get("mode") == "mixed" for p in phases):
        # staged DEX seeding through consensus: issuer create in its
        # own close, then trustlines, then funding (apply order inside
        # one ledger is hash-shuffled, so each stage must land first)
        for env in lg.create_dex_issuer_envelope():
            assert app0.herder.recv_transaction(env) == 0
        assert sim.crank_until(
            _applied(lg.dex_issuer.public_key().raw), 120.0), \
            f"[{label}] DEX issuer seeding stalled"
        for env in lg.setup_dex_envelopes() + lg.fund_dex_envelopes():
            assert app0.herder.recv_transaction(env) == 0
        target = max(a.ledger_manager.last_closed_seq()
                     for a in sim.alive_nodes().values()) + 2
        assert sim.crank_until(
            lambda: sim.have_all_externalized(target), 120.0), \
            f"[{label}] DEX trustline seeding stalled"

    # rate-mode generation batches land on the generator app's fair
    # scheduler; a single-node rig drains it in Application.crank, but
    # sim rigs crank the SHARED clock directly and never touch per-app
    # schedulers — so traffic needs its own deterministic pump (a
    # virtual timer, like every other scheduled piece of the scenario)
    pump_timer = VirtualTimer(sim.clock, owner=chaos)

    def pump():
        if not sim.crashed.get(sorted(sim.nodes)[0], False):
            while app0.scheduler.run_one():
                pass
        pump_timer.expires_from_now(0.5)
        pump_timer.async_wait(pump)

    pump()
    chaos._timers.append(pump_timer)

    def start_phase(c, p):
        _flush_phase_report(lg, phase_reports)
        lg.start_rate_run(
            mode=p.get("mode", "pay"), rate=float(p["rate"]),
            duration=float(p["duration"]),
            dex_percent=int(p.get("dex_percent", 50)))

    merged = list(events)
    for p in phases:
        elabel = (f"traffic {p.get('mode', 'pay')}@{p['rate']}tx/s "
                  f"for {p['duration']}s")
        merged.append((float(p["t"]), elabel,
                       lambda c, p=p: start_phase(c, p)))
    return lg, merged


def _flush_phase_report(lg, phase_reports: List[dict]) -> None:
    """Snapshot the finished rate run's accounting (one dict per
    completed phase; resets the generator so the next flush can never
    double-count)."""
    st = lg.rate_status()
    if "mode" in st:
        phase_reports.append({
            "mode": st["mode"], "rate": st["rate"],
            "ticks": st["ticks"], "submitted": st["submitted"],
            "status_counts": dict(sorted(st["status_counts"].items()))})
    lg._rate_state = None


def _traffic_oracle(sim: Simulation, traffic: List[dict],
                    phase_reports: List[dict], label: str) -> dict:
    """Traffic accounting contract: every phase started, and every
    submitted tx carries a recorded admission status (the submit and
    status counters increment together or the generator lost track of
    a tx).  Returns the report's ``traffic`` section, including the
    tx-queue overload counters — ban-set depth and aging/surge
    admission statuses (TRY_AGAIN_LATER=3, BANNED=4) — that overload
    scenarios assert against."""
    assert len(phase_reports) == len(traffic), \
        (f"[{label}] only {len(phase_reports)}/{len(traffic)} traffic "
         f"phases ran — phase timers must fire inside the duration")
    for rep in phase_reports:
        assert rep["submitted"] == sum(rep["status_counts"].values()), \
            f"[{label}] traffic accounting leak: {rep}"
    submitted_total = sum(r["submitted"] for r in phase_reports)
    expected = sum(float(p["rate"]) * float(p["duration"])
                   for p in traffic)
    if expected >= 2.0:
        assert submitted_total > 0, \
            (f"[{label}] traffic oracle: {expected:.0f} txs expected "
             f"but none submitted")
    queue = {"pending": 0, "banned": 0}
    for app in sim.alive_nodes().values():
        tq = app.herder.tx_queue
        queue["pending"] += app.metrics.counter(
            "herder.pending-txs.count").count
        queue["banned"] += len(set().union(*tq.banned)) if tq.banned \
            else 0
    statuses: Dict[str, int] = {}
    for rep in phase_reports:
        for k, v in rep["status_counts"].items():
            statuses[k] = statuses.get(k, 0) + v
    return {"phases": phase_reports,
            "submitted_total": submitted_total,
            "status_totals": dict(sorted(statuses.items())),
            "queue": queue}


def run_scenario(make_sim: Callable[[], Simulation], seed: int,
                 events: List[Tuple[float, str,
                                    Callable[[ChaosEngine], None]]],
                 duration: float, label: str,
                 converge_timeout: float = 120.0,
                 forensics_dir: Optional[str] = None,
                 traffic: Optional[List[dict]] = None) -> dict:
    """Run one scripted chaos scenario end to end and return its report.

    ``events`` is a list of (virtual-time offset, label, fn(chaos));
    after ``duration`` virtual seconds of free-running consensus under
    those faults the runner clears every remaining fault (heal + link
    clear + restore of still-crashed nodes), waits for the honest
    survivors to converge two more ledgers, and asserts the safety
    contract: no forks (header chain + bucket hash), convergence within
    ``converge_timeout`` virtual seconds.  An invariant violation or a
    crash anywhere in a close raises out of the crank and fails the
    scenario — those are P0s, not statistics.

    ``traffic`` makes loadgen rate mode a first-class scenario phase
    (ROADMAP item 6: load running THROUGH the faults): a list of
    ``{"t": offset, "duration": s, "mode": "pay"|"pretend"|"mixed",
    "rate": tx/s, "dex_percent": int}`` dicts.  Before the fault window
    the runner seeds generator accounts through real consensus (a
    direct ledger write on a live network would itself be a fork), arms
    each phase as a scripted event on one node's LoadGenerator, and the
    report gains a ``traffic`` section: per-phase submit/status
    accounting (asserted consistent: every submit has a recorded
    admission status) plus the tx-queue overload counters (pending
    depth, ban-set size, TRY_AGAIN_LATER/BANNED statuses — the aging
    and surge-lane evidence).  Phases must not overlap: one generator
    drives one rate run at a time.

    When any oracle FAILS (fork, convergence/heal timeout, unfired
    script, traffic accounting), the runner dumps the merged cross-node
    slot timeline with first-divergence attribution to
    ``FORENSICS_*.json`` under ``forensics_dir`` (cwd by default) and
    raises ``ScenarioFailure`` with the oracle's ``failure_class`` and
    the artifact path — a failing schedule becomes a readable timeline,
    not a rerun-and-guess.
    """
    sim = make_sim()
    chaos = ChaosEngine(sim, seed)
    sim.start_all_nodes()
    while sim.crank():
        pass  # handshakes settle at t=0
    chaos.start_maintenance()
    clock = sim.clock

    lg = None
    phase_reports: List[dict] = []
    if traffic:
        lg, events = _arm_traffic(sim, chaos, list(traffic),
                                  list(events), phase_reports, label)

    t0 = clock.now()
    for offset, elabel, fn in events:
        t = VirtualTimer(clock, owner=chaos)
        t.expires_from_now(max(0.0, (t0 + offset) - clock.now()))
        t.async_wait(lambda fn=fn, elabel=elabel: (
            chaos.log_event(f"event: {elabel}"), fn(chaos)))
        chaos._timers.append(t)

    t_end = t0 + duration
    while clock.now() < t_end:
        if clock.crank(block=True) == 0 and \
                clock.next_deadline() is None:
            break

    def _oracle_failed(err: AssertionError,
                       failure_class: str = "oracle") -> None:
        """Any failed oracle dumps the merged forensic timeline and
        re-raises with the artifact path attached."""
        chaos.stop()
        try:
            path = dump_forensics(
                collect_forensics(sim, chaos, label, seed,
                                  reason=str(err)), forensics_dir)
        finally:
            for nid in list(sim.alive_nodes()):
                sim.nodes[nid].stop_node()
        raise ScenarioFailure(
            failure_class, f"{err}\n[forensics] {path}",
            forensics_path=path) from None

    # every scripted event must have fired inside the fault window — a
    # scenario whose script outlives its duration silently tests
    # nothing (the tiered stale_replay caught this: its replay timer
    # was cancelled before firing and the run reported a clean pass)
    fired = sum(1 for _, what in chaos.events
                if what.startswith("event: "))
    if fired != len(events):
        _oracle_failed(AssertionError(
            f"[{label}] only {fired}/{len(events)} scripted events fired "
            f"within duration {duration}s — extend the duration to cover "
            f"the script"), "unfired-script")

    # clear every remaining fault and start the heal stopwatch
    for nid in sorted(n for n, dead in sim.crashed.items() if dead):
        chaos.restore(nid)
    chaos.heal()
    chaos.clear_links()
    chaos.maintain_links_once()
    heal_start = max(chaos.last_clear_time, clock.now())
    honest = chaos.honest_alive()
    target = max(sim.nodes[n].ledger_manager.last_closed_seq()
                 for n in honest) + 2

    def converged_slot() -> Optional[int]:
        """First slot >= target that EVERY honest survivor externalized
        with one hash.  Any common slot counts, not just the target: a
        node that rejoined through out-of-sync recovery catches up PAST
        the target without re-externalizing it — a recording gap, not a
        safety problem."""
        recs = [chaos.extern_hashes.get(nid, {}) for nid in honest]
        common = set(recs[0]) if recs else set()
        for rec in recs[1:]:
            common &= set(rec)
        for s in sorted(x for x in common if x >= target):
            if len({rec[s] for rec in recs}) == 1:
                return s
        return None

    deadline = heal_start + converge_timeout
    while clock.now() < deadline and converged_slot() is None:
        if clock.crank(block=True) == 0 and \
                clock.next_deadline() is None:
            break
    conv = converged_slot()
    if conv is None:
        # a convergence timeout CAUSED by divergent histories is a
        # fork, not a liveness problem — classify by the symptom's
        # root so the fuzzer's ddmin matcher sees one stable class
        div = first_hash_divergence(chaos)
        _oracle_failed(AssertionError(
            f"[{label}] honest survivors failed to converge on seq "
            f"{target} within {converge_timeout}s virtual: "
            f"{[(n.hex()[:8], sim.nodes[n].ledger_manager.last_closed_seq()) for n in honest]}"
            + (f" (diverged at slot {div['slot']})" if div else "")),
            "fork" if div else "convergence-timeout")
    # healed when the LAST honest node externalized the agreed slot
    time_to_heal = round(
        max(0.0, max(
            chaos.extern_times[n][conv][0] for n in honest
            if conv in chaos.extern_times.get(n, {})) - heal_start), 3)
    chaos.stop()

    # safety: full header-chain + bucket-hash agreement, all honest pairs
    try:
        fork_comparisons = sim.assert_no_forks(honest)
    except AssertionError as e:
        _oracle_failed(e, "fork")

    # traffic accounting oracle: every phase must have started and
    # every submitted tx must carry a recorded admission status
    traffic_report = None
    if traffic:
        lg.stop_rate_run()
        _flush_phase_report(lg, phase_reports)
        try:
            traffic_report = _traffic_oracle(
                sim, traffic, phase_reports, label)
        except AssertionError as e:
            _oracle_failed(e, "traffic")

    # close-latency statistics over the whole run
    spread_ms: List[float] = []
    wall_ms: List[float] = []
    cadence_s: List[float] = []
    all_seqs = sorted({s for nid in honest
                       for s in chaos.extern_times.get(nid, {})})
    prev_wall_end = None
    for s in all_seqs:
        vts = [chaos.extern_times[nid][s][0] for nid in honest
               if s in chaos.extern_times.get(nid, {})]
        wts = [chaos.extern_times[nid][s][1] for nid in honest
               if s in chaos.extern_times.get(nid, {})]
        if len(vts) >= 2:
            spread_ms.append((max(vts) - min(vts)) * 1000.0)
        if prev_wall_end is not None:
            wall_ms.append((max(wts) - prev_wall_end) * 1000.0)
        prev_wall_end = max(wts)
        cadence_s.append(max(vts))
    cadence_diffs = [b - a for a, b in zip(cadence_s, cadence_s[1:])]

    report = {
        "scenario": label,
        "seed": seed,
        "nodes": len(sim.nodes),
        "byzantine": len(chaos.byzantine),
        "ledgers_closed": len(all_seqs),
        "close_spread_virtual_ms": _percentiles(spread_ms),
        "round_wall_ms": _percentiles(wall_ms),
        "cadence_virtual_s": _percentiles(cadence_diffs),
        "virtual_elapsed_s": round(clock.now() - t0, 3),
        "time_to_heal_s": time_to_heal,
        "counters": chaos.chaos_counters(),
        "fork_check": "pass",
        "fork_comparisons": fork_comparisons,
        "fingerprint": chaos.fingerprint(),
        "events": chaos.events,
        # raw per-node externalize record (hash prefixes): the
        # rerun-mismatch oracle's forensic material — chaos_bench
        # diffs two runs' maps to name the first (node, seq) that
        # diverged between reruns
        "per_node_externalized": {
            nid.hex()[:8]: {str(s): h.hex()[:16]
                            for s, h in sorted(
                                chaos.extern_hashes[nid].items())}
            for nid in sorted(chaos.extern_hashes)},
    }
    if traffic_report is not None:
        report["traffic"] = traffic_report
    # release node resources (DB handles, pools) without stopping the
    # clock mid-assert; the sim object dies with this frame
    for nid in list(sim.alive_nodes()):
        sim.nodes[nid].stop_node()
    return report


# ---------------------------------------------------------------------------
# the canned scenario suite (tests + tools/chaos_bench.py share these)
# ---------------------------------------------------------------------------

def scenario_events(sim_ids: List[bytes], scenario: str,
                    rng: random.Random) -> List[tuple]:
    """Build the event script for one named scenario over the given node
    ids (callers pass the topology's node order; victim choices draw
    from ``rng`` so they derive from the chaos seed)."""
    n = len(sim_ids)
    if scenario == "partition_heal":
        # cut off a minority third for a while, then heal
        cut = rng.sample(sim_ids, max(1, n // 3))
        keep = [x for x in sim_ids if x not in cut]
        return [
            (3.0, "partition minority",
             lambda c, g=[keep, cut]: c.partition(g)),
            (13.0, "heal", lambda c: c.heal()),
        ]
    if scenario == "crash_restore":
        victim = rng.choice(sim_ids)
        return [
            (3.4, "crash mid-close",
             lambda c, v=victim: c.crash(v)),
            (9.0, "restore from state",
             lambda c, v=victim: c.restore(v)),
        ]
    if scenario == "laggard":
        victim = rng.choice(sim_ids)
        return [
            (2.0, "laggard +2.5s",
             lambda c, v=victim: c.lag(v, 2.5)),
            (12.0, "unlag", lambda c, v=victim: c.lag(v, 0.0)),
        ]
    if scenario == "flaky_links":
        victims = rng.sample(sim_ids, max(2, n // 4))

        def flake(c, vs=victims):
            for v in vs:
                for a, b in c.sim.topology:
                    if v in (a, b):
                        c.set_link(a, b, drop=0.02, duplicate=0.01,
                                   damage=0.01)
        return [
            (2.0, "flaky links on", flake),
            (12.0, "links clean", lambda c: c.clear_links()),
        ]
    if scenario == "stale_replay":
        attacker = rng.choice(sim_ids)
        # replay late enough that the earliest captured slots are BOTH
        # past the floodgate's dedup TTL (so the replay isn't absorbed
        # as a duplicate) and below the herder's slot bracket (so the
        # discard path, not SCP, sheds them)
        return [
            (0.5, "capture scp",
             lambda c, a=attacker: c.capture_scp(a)),
            (16.0, "replay stale envelopes",
             lambda c, a=attacker: c.replay_stale(
                 a, max_age_slot=c.sim.nodes[a].ledger_manager
                 .last_closed_seq() - 2)),
        ]
    if scenario == "equivocator":
        # a Byzantine minority equivocates from the start
        byz = rng.sample(sim_ids, max(1, (n - 1) // 4))
        return [(1.0, f"equivocate x{len(byz)}",
                 lambda c, bs=byz: [c.equivocate(b) for b in bs])]
    raise ValueError(f"unknown scenario {scenario!r}")


STANDARD_SCENARIOS = ("partition_heal", "crash_restore", "laggard",
                      "flaky_links", "stale_replay", "equivocator")


def run_standard_scenario(make_sim: Callable[[], Simulation],
                          scenario: str, seed: int, n_nodes: int,
                          duration: float = 20.0,
                          converge_timeout: float = 120.0,
                          forensics_dir: Optional[str] = None) -> dict:
    """Resolve a named scenario against the canned topologies' node
    order (node ids are a pure function of the node index, so no sim
    needs building to know them) and run it.  The victim-choosing RNG
    derives from (seed, scenario) so every scenario of a bench run is
    independently deterministic."""
    from .simulation import _ids, _seeds

    ids = _ids(_seeds(n_nodes))
    rng = random.Random(int.from_bytes(
        sha256(b"chaos-scenario-%d-" % seed + scenario.encode()), "big"))
    events = scenario_events(ids, scenario, rng)
    # the fault window must cover the whole event script (plus slack
    # for the last fault to bite) — otherwise late events like
    # stale_replay's t=16 injection never fire on short-duration tiers
    duration = max(duration, max(t for t, _, _ in events) + 2.0)
    return run_scenario(make_sim, seed, events, duration, scenario,
                        converge_timeout=converge_timeout,
                        forensics_dir=forensics_dir)
