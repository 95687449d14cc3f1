"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line):
  1. card    — name and power limit; exits non-zero before building
               anything when no CUDA device is present;
  2. build   — nvcc builds every hand-written kernel from csrc/ in this
               run; ptxas's registers, spills (any spill fails) and stack
               frame, and the main path's launch shape;
  3. compare — the ed25519 kernel against its plain torch version, both on
               the card, on the 26 libsodium edge vectors plus 4,096 seeded
               rows (1/8 forged), and 256 rows against the spec; the
               kernel's test-only double-scalar entry against the spec on
               the special scalars;
  4. main    — ``admission_step`` on a 100,000-signature TxSetFrame batch
               (BASELINE config #2) padded to 131,072, and
               ``multi_validator_tally`` on a 64-validator 2-level FBA
               topology (BASELINE config #5); verdicts exact against the
               known forged mask and a recursive host oracle; every kernel
               must have been launched during this phase;
  5. scp     — live SCP consensus (BASELINE config #5): 64 port ``SCP``
               instances on the same topology as XDR quorum sets, each
               with ``tally_backend="both"`` on the card, nominate and
               externalize 1 slot (2 before this cut) over an all-to-all
               bus; each delivery round's envelope signatures
               (plus one forged copy) go through the verify kernel as one
               padded batch.  Every node must externalize one common
               value per slot, no tensor tally may differ from the host
               oracle, none may fall back to the host, every forged
               envelope must be refused, and the kernel must have been
               launched once per round;
  6. quorum_intersection — the port's ``check_quorum_intersection``
               (BASELINE config #3) on three networks: (a) the twisted
               majority cliques of 16 and 24 nodes through the native,
               numpy and device tiers, which must agree where they finish
               (4,003 and 155,039 subproblems); (b) the ``scp`` phase's 64
               validators as node 0's ``QuorumTracker`` sees them, answered
               by ``org:native`` and, with the native tier off,
               ``org:device``; (c) a 1,040-node tiered org network past
               the native tier's 1,024-node ceiling, with default routing:
               the device tier under a call budget (an aborted scan, never
               a false verdict), and with a low threshold a split that the
               device tier finds.  ``ContractorProbe`` times every device
               chunk by CUDA events, counts its trips and holds its rows
               to a numpy fixpoint;
  7. node    — BASELINE config #1 on the port alone: a standalone node
               (``Application``, ``CRYPTO_BACKEND="cuda"``, tallies
               ``"tensor"``, the node's default parallel apply, pipelined
               close and native tiers) seeds 1,000 accounts in one close,
               closes 3 ledgers of 1,000 one-signature payments through
               ``recv_transaction`` and ``manual_close()``, then a peer's
               1,000-payment set with every 100th signature forged through
               ``close_ledger``; node B, on the ``"cpu"`` backend, gets the
               same envelopes.  Every close launches the verify kernel once
               (1,000 rows padded to 1,024), its verdicts answer every
               signature (no host verify in the close), every payment is
               ``txSUCCESS`` and every forged one ``txBAD_AUTH``; A equals
               B in ledger hash, bucket-list hash and meta bytes after every
               close; the native libraries built and served the closes.
               Per close: the phases' ms, the verify phase's dispatch /
               host-wait split, signing and admission seconds; one close's
               batch replayed by CUDA events;
  8. network — 21 validators in 7 organisations of 3 (the public
               network's tier 1; ``simulation.hierarchical_quorum(7, 3)``)
               reach consensus over the loopback overlay: network A on
               ``CRYPTO_BACKEND="cuda"`` with ``"both"`` tallies on the card
               closes a ledger in which the root creates 100 accounts and 2
               ledgers of 100 payments submitted round-robin to the nodes;
               each node's per-crank SCP envelope batch of 2 or more triples
               is one launch (``OverlayManager._verify_triples``), each
               close with transactions one more; one forged envelope
               injected into a drain of ledger 3 is primed False and
               refused; no tally differs from the host oracle; network B on
               the ``"cpu"`` / ``"host"`` tiers gives the same header hash
               in every ledger; the kernel equals its plain version on the
               overlay batch that held the forged envelope; the phase stays
               within 150 s;
  9. bench   — the port's headline bench (``stellar_core_tpu_torch.bench``)
               at 100,000 signatures and 2 closes a shape (its default 24,
               cut): config #2's LoadGenerator payments through
               ``TxSetFrame.make_from_wire`` and ``collect_signature_batch``,
               padded to 131,072 rows, through the kernel (every verdict
               true, equal to the plain version), against sequential
               OpenSSL verifies on the same host, and the close's
               ``prevalidate_signatures`` on the same set; config #1's
               1,000-tx closes (payments, 30% DEX mixed, mixed with tracing
               off) on a ``cuda`` node and a ``cpu`` node fed the same bytes,
               with equal ledger hashes after every close; the bench's
               lines, its last line as its own line;
 10. parallel — ``bench_sharded`` over the visible cards on the bench's
               batch (from a workload file), and ``dryrun_multichip(8)``
               over 8 CPU chunks, equal to the unsharded step;
 11. cli     — two ``python -m stellar_core_tpu_torch --conf <toml> run``
               processes (``CRYPTO_BACKEND="cuda"``, a 2-of-2 quorum over
               localhost TCP), driven over their admin HTTP: ``tx?blob=``,
               ``generateload`` create and pay, ``quorum?intersection=
               true``; both close 3 more ledgers with one header hash, and
               each launched the kernel for its overlay batches and its
               closes (``/metrics``); ``tools.fleet_scrape`` polls both for
               2 rounds (both reachable, ledger spread at most 1); the
               children are killed on exit;
 12. catchup — BASELINE config #4, the herder's ledger-close replay of a
               catchup history range: a ``cpu``-backend publisher with
               1,000 accounts archives 3 checkpoints of 8 ledgers (16
               ledgers of 1,000 payments, a peer's 1,000-payment set with
               every 100th signature forged, empty ledgers); cold joiner A
               (complete, ``CRYPTO_BACKEND="cuda"`` on the card), B
               (complete, ``"cpu"``) and C (minimal to the forged ledger,
               ``"cuda"``) catch up through ``CatchupWork``: every joiner
               equals the publisher in every header and bucket-list hash,
               each replayed ledger with signatures is one launch on a
               ``cuda`` joiner, A's forged-ledger results equal B's, the
               kernel equals its plain version on A's forged batch; the
               replay ledgers/s and the verify phase of each joiner;
 13. chaos   — ``chaos_bench``'s core-4 tier through ``partition_heal``,
               ``flaky_links`` and ``equivocator`` at seed 11, twice on the
               card (``"cuda"``, ``"both"`` tallies; the first with a forged
               envelope in every node's inbox, refused) and once on a
               ``"cpu"`` / ``"host"`` twin: all three fingerprints equal the
               JAX package's, no tally mismatch, the kernel equal to its
               plain version on every distinct triple it verified;
 14. fuzz    — ``verify_repro`` of both ``traces/FUZZ_REPRO_*.json`` with
               the executor's networks on the card (``"cuda"``, ``"both"``):
               each reproduces its committed class and fingerprint;
 15. tools   — the port's benchmark tools (``stellar_core_tpu_torch.tools``)
               in-process on the card: ``pipeline_bench``'s parity pass
               (the carried workload pipeline on vs off on ``cuda`` nodes,
               equal per close, its last ledger hash equal to a ``cpu``
               node's), one ``parallel_apply_bench`` fingerprint (pay,
               workers 2, 2 closes of 1,000 txs) on a ``cuda`` node equal
               to a ``cpu`` node's, ``soak_bench`` at 100 tx/s for 10 s on
               a ``cuda`` node (every submitted tx admitted and applied),
               and ``scp_forensics_bench``'s induced-fork probe at seed 14
               on a ``cuda`` core-4 network (attributed to the Byzantine
               node, rerun byte-identical, the dump equal to the committed
               ``FORENSICS_induced_fork_seed14.json``); each launched the
               kernel;
 16. netobs  — ``chaos_bench --netobs``'s core-4 tier (chaos and rate-mode
               load, the observatory and the crank profiler armed, flood
               tracing on, then off) on a ``cuda`` arm (the verify kernel
               for every node's envelope batches, tensor tallies on the
               card) and a ``cpu`` arm, the backends in turns: the five
               gates hold on both arms, the arms' digests are equal, each
               arm's crank wall split by subsystem and overlay batches are
               printed, and ``tools.trace_view.render_propagation`` renders
               the ``cuda`` arm's observatory summary;
 17. times   — CUDA-event times (warm-up excluded) with the card's name
               and power limit: the kernel, ``admission_step``, one
               recorded live tally call replayed, with the contraction
               trips, CUDA runtime calls and device kernels of one replay
               (torch.profiler), and the verify kernel's bound from the
               work that this run's rows need.
Then the per-kernel JSON line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""
from __future__ import annotations

import collections
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 100_000      # TxSetFrame signatures (BASELINE config #2)
N_TRIPLES = 4096      # distinct signed triples, tiled to N_ROWS
N_KEYS = 64
N_ORGS, ORG_SIZE = 16, 4   # 64 validators (BASELINE config #5)
TOP_THR, INNER_THR = 11, 3
N_CANDIDATES = 64
REPS = 5
SCP_SLOTS = 1         # slots the 64-validator network externalizes (was 2)
LIVE_REPS = 50        # replays of one recorded live tally call
QI_CLIQUES = (16, 24)     # twisted majority cliques (BASELINE config #3)
QI_CLIQUE_SCANNED = {16: 4003, 24: 155039}   # the JAX package's counts
QI_MAX_SECONDS = 60       # budget of each tier on a clique
QI_ORGS, QI_CORE_ORGS, QI_LISTED = 260, 10, 250   # 1,040 nodes, each
                                                  # listing 1,000
QI_MAX_CALLS = 30_000     # subproblems of the 1,040-node scan
MAX_ROUNDS = 10_000   # delivery rounds before a network counts as stuck
NODE_ACCOUNTS = 1000      # BASELINE config #1: 1k-payment TxSetFrame
NODE_CREATE_OPS = 100     # CREATE_ACCOUNT ops in each seeding transaction
NODE_CLOSES = 3           # closes of one payment per account
NODE_FORGE_EVERY = 100    # every 100th payment of the forged set forged
NET_ORGS, NET_PER_ORG = 7, 3   # the public network's tier 1: 7 orgs of 3
NET_ACCOUNTS = 100        # ops a ledger: a simulated node's default
                          # TESTING_UPGRADE_MAX_TX_SET_SIZE
NET_PAYMENT_LEDGERS = 2   # ledgers of one payment per account
NET_FORGE_SEQ = 3         # the slot whose drain gets one forged envelope
NET_MAX_SECONDS = 150     # budget of the network phase
NET_SETTLE_CRANKS = 1000  # cranks before a network counts as stuck
CATCHUP_PAYMENT_LEDGERS = 16   # config #4: 1,000-payment ledgers published
CATCHUP_CHECKPOINTS = 3        # checkpoints of 8 ledgers the archive holds
CATCHUP_MAX_SECONDS = 120      # budget of one joiner's catchup
BENCH_SIGNATURES = 100_000   # config #2, the bench's default
BENCH_CLOSES = 2          # closes a shape (the bench's default 24, cut)
BENCH_CLOSE_TXS = 1000    # config #1: 1,000-tx ledgers
CHAOS_SCENARIOS = ("partition_heal", "flaky_links", "equivocator")
CHAOS_SEED = 11           # chaos_bench's default seed
CHAOS_FORGE_SEQ = 2       # the slot whose drains get one forged envelope
# the JAX package's core-4 fingerprints at CHAOS_SEED
# (tests/test_torch_chaos.py holds them to it)
CHAOS_FINGERPRINTS = {
    "partition_heal":
        "d1ac534ad75734744f78cd525cb6db113aed2bdab9152a1d62bcc7eca5af4c66",
    "flaky_links":
        "ac55ee080dccfc6038c6d50e9d83b4098c1875d32b6dcfd02c4d6da6fefbc57d",
    "equivocator":
        "4b5fc802a250d5d9be6bb1cdeb43f0c51bbbaec1881e26a0a2926898ec5dd0e5",
}
CLI_PASSPHRASE = "tcp process test net"
CLI_ACCOUNTS = 100        # generateload accounts, and payments
CLI_LEDGERS = 3           # ledgers both CLI nodes close after the traffic
CLI_MAX_SECONDS = 150     # budget of the cli phase
CLI_COUNTERS = ("overlay.sigbatch.batches", "overlay.sigbatch.envelopes",
                "ledger.ledger.count")
# a ``cuda`` node's gauge of the verify kernel's own launch counter
CLI_LAUNCHES = "crypto.verify.kernel-launches"
TOOLS_WORKERS = 2          # parallel apply workers of the tools' nodes
TOOLS_APPLY_CLOSES = 2     # parallel_apply_bench's parity closes
TOOLS_APPLY_TXS = 1000     # ... of 1,000 payments (its default)
TOOLS_SOAK_RATE = 100.0    # soak_bench's default rate, tx/s
TOOLS_SOAK_SECONDS = 10.0  # its default 200 s, cut
TOOLS_SOAK_ACCOUNTS = 1000  # its default 3,000, cut
NETOBS_TIER = "core4"      # chaos_bench --netobs's core-4 tier
NETOBS_SEED = 11           # its default seed
CLI_SCRAPE_ROUNDS = 2      # fleet_scrape rounds over the CLI nodes
NODE_PHASES = ("prefetch", "verify", "fee", "plan", "apply", "hash",
               "bucket", "stage", "commit", "meta", "total")
SEED = 20260601
L = 2**252 + 27742317777372353535851937790883648493

# Scalars below 2^253 (every h, and every s that can be accepted) at the
# edges of the kernel's signed radix-16 recoding.
SPECIAL_SCALARS = {
    "0": 0, "1": 1, "8": 8, "15": 15, "16": 16, "L-1": L - 1,
    "2^252": 2**252, "2^253-1": 2**253 - 1,
    "nibbles_8": int("8" * 63, 16),
    "alt_0f_f0": int.from_bytes(bytes([0x0F, 0xF0] * 15 + [0x0F, 0x10]),
                                "little"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def edge_vectors(ref, sha256):
    """The 26 libsodium edge vectors (valid, bad-sig, 10 small-order A,
    10 small-order R, non-canonical A and R, malleable s, off-curve A)."""
    seed, msg = sha256(b"edge0"), sha256(b"edge-msg0")
    pk, sig = ref.public_from_seed(seed), ref.sign(seed, msg)
    out = [(pk, sig, msg), (pk, sig[:-1] + bytes([sig[-1] ^ 1]), msg)]
    out += [(enc, sig, msg) for enc in ref.SMALL_ORDER_ENCODINGS]
    out += [(pk, enc + sig[32:], msg) for enc in ref.SMALL_ORDER_ENCODINGS]
    nc = int.to_bytes(ref.P + 1, 32, "little")
    out += [(nc, sig, msg), (pk, nc + sig[32:], msg)]
    s = int.from_bytes(sig[32:], "little")
    out.append((pk, sig[:32] + int.to_bytes(s + ref.L, 32, "little"), msg))
    y = 2
    while ref._recover_x(y, 0) is not None:
        y += 1
    out.append((int.to_bytes(y, 32, "little"), sig, msg))
    from stellar_core_tpu_torch.utils.device import signature_columns

    return signature_columns(out)


def signed_triples(ref, sha256, rng):
    """N_TRIPLES distinct (pubkey, sig, msg) from N_KEYS keys."""
    seeds = [sha256(b"smoke-key%d" % k) for k in range(N_KEYS)]
    pubs = [np.frombuffer(ref.public_from_seed(s), np.uint8) for s in seeds]
    msgs = rng.integers(0, 256, (N_TRIPLES, 32), dtype=np.uint8)
    pk = np.stack([pubs[i % N_KEYS] for i in range(N_TRIPLES)])
    sg = np.stack([np.frombuffer(ref.sign(seeds[i % N_KEYS], msgs[i].tobytes()),
                                 np.uint8) for i in range(N_TRIPLES)])
    return pk, sg, msgs


def forge(pk, sg, mg, rows):
    """Copies with one flipped byte in the sig (even i) or msg (odd i) of
    each listed row."""
    sg, mg = sg.copy(), mg.copy()
    for i, r in enumerate(rows):
        if i % 2 == 0:
            sg[r, r % 64] ^= 0x01
        else:
            mg[r, r % 32] ^= 0x80
    return pk, sg, mg


def fba_topology():
    """16 orgs x 4 validators; every qset: 11 of the 16 org inner sets,
    each inner set 3 of 4."""
    orgs = [list(range(o * ORG_SIZE, (o + 1) * ORG_SIZE))
            for o in range(N_ORGS)]
    qset = (TOP_THR, [], [(INNER_THR, org) for org in orgs])
    return [qset] * (N_ORGS * ORG_SIZE)


# -- recursive host oracle (plain python, 2-level qsets) ---------------------

def ref_slice(qset, s):
    thr, vals, inners = qset
    hits = sum(1 for v in vals if v in s)
    hits += sum(1 for ithr, ivals in inners
                if ithr > 0 and sum(1 for v in ivals if v in s) >= ithr)
    return hits >= thr


def ref_vblocking(qset, s):
    thr, vals, inners = qset
    if thr == 0:
        return False
    avail = sum(1 for v in vals if v not in s)
    avail += sum(1 for ithr, ivals in inners
                 if ithr > 0 and sum(1 for v in ivals if v not in s) >= ithr)
    return avail < thr


def ref_max_quorum(qsets, members):
    cur = set(members)
    while True:
        nxt = {n for n in cur if ref_slice(qsets[n], cur)}
        if nxt == cur:
            return nxt
        cur = nxt


def oracle_tally(qsets, voted, accepted):
    """(accept, ratify) as (V, C) bool arrays, validator v with qsets[v]."""
    n_val, n_c = len(qsets), voted.shape[0]
    acc = np.zeros((n_val, n_c), np.bool_)
    rat = np.zeros((n_val, n_c), np.bool_)
    for c in range(n_c):
        q = ref_max_quorum(qsets, set(np.nonzero(voted[c] | accepted[c])[0]))
        a_set = set(np.nonzero(accepted[c])[0])
        for v in range(n_val):
            rat[v, c] = bool(q) and ref_slice(qsets[v], q)
            acc[v, c] = rat[v, c] or ref_vblocking(qsets[v], a_set)
    return acc, rat


# -- live SCP network (test scaffolding for the scp phase) --------------------

class _NodeDriver:
    """One validator's SCPDriver: signs each envelope over
    sha256(ENVELOPE_TYPE_SCP || network id || SCPStatement) as the herder
    does, puts it on the network's bus, answers ``verify_envelope`` from
    the verdicts the network primed for its round (an envelope that is in
    no verified batch raises), and arms its timers on the network's
    virtual clock."""

    def __init__(self, net, index: int, seed: bytes):
        self.net, self.index, self.seed = net, index, seed
        self.node_id = net.public(seed)
        self._sig_verdicts: dict = {}

    def validate_value(self, slot_index, value, nomination):
        return self.net.S.ValidationLevel.FULLY_VALIDATED

    def combine_candidates(self, slot_index, candidates):
        return max(candidates)

    def sign_envelope(self, env) -> None:
        env.signature = self.net.sign(self.seed, self.net.signed_hash(env))
        env.__dict__.pop("_xdr_enc", None)   # memoized pre-sign encoding

    def prime_sig_verdicts(self, triple_verdicts) -> None:
        self._sig_verdicts = dict(triple_verdicts)

    def verify_envelope(self, env) -> bool:
        return self._sig_verdicts[self.net.sig_triple(env)]

    def emit_envelope(self, env) -> None:
        self.net.outbox.append((self.index, env))

    def get_qset(self, h):
        return self.net.qsets.get(h)

    def setup_timer(self, slot_index, timer_id, timeout, cb) -> None:
        key = (self.index, slot_index, timer_id)
        self.net.timers.pop(key, None)
        if cb is not None and timeout > 0:
            self.net.timers[key] = (self.net.now + timeout, cb)

    def value_externalized(self, slot_index, value) -> None:
        self.net.externalized.setdefault(slot_index, {})[self.index] = value


class Network:
    """``len(seeds)`` validators of one SCP package on an all-to-all bus.

    ``scp_pkg`` and ``types`` are a package's ``scp`` and ``xdr.types``
    modules (the port's here; the CPU tests also pass the JAX package's).
    ``qset_of(make_qset, node_ids)`` gives the one quorum set every node
    uses.  ``verify(triples)`` returns one verdict per (pubkey, sig,
    msg32) triple.  A delivery round takes every envelope on the bus,
    verifies their signatures and one forged copy of one of them (a
    flipped signature byte) as one batch, primes every node with the
    verdicts and delivers each envelope to every other node in order; the
    forged copy must be refused by every node.  When the bus is empty, the
    virtual clock jumps to the earliest armed timer and fires every timer
    due then.  Everything runs in a fixed order, so two packages given
    the same seeds emit the same bytes."""

    def __init__(self, scp_pkg, types, seeds, qset_of, sign, public,
                 sha256, verify, scp_kwargs):
        self.S, self.T = scp_pkg, types
        self.sign, self.public, self.sha256 = sign, public, sha256
        self.verify = verify
        network_id = sha256(b"Test SDF Network ; September 2015")
        self._prefix = types.EnvelopeType.encode(
            types.EnvelopeType.ENVELOPE_TYPE_SCP) + network_id
        driver_cls = type("NodeDriver", (_NodeDriver, scp_pkg.SCPDriver), {})
        self.drivers = [driver_cls(self, i, s) for i, s in enumerate(seeds)]
        self.qset = qset_of(scp_pkg.make_qset,
                            [d.node_id for d in self.drivers])
        self.qsets = {scp_pkg.qset_hash(self.qset): self.qset}
        self.nodes = [scp_pkg.SCP(d, d.node_id, True, self.qset,
                                  **scp_kwargs)
                      for d in self.drivers]
        self.outbox: list = []
        self.timers: dict = {}
        self.now = 0.0
        self.externalized: dict = {}
        self.emitted: list = []      # (sender, envelope bytes), in order
        self.stats = {"rounds": 0, "envelopes": 0, "batch_sizes": [],
                      "forged_refused": 0, "timers_fired": 0}

    def signed_hash(self, env) -> bytes:
        return self.sha256(self._prefix + self.T.SCPStatement.encode(
            env.statement))

    def sig_triple(self, env) -> tuple:
        return (env.statement.nodeID.value, env.signature,
                self.signed_hash(env))

    def _forged(self, env):
        sig = bytearray(env.signature)
        sig[self.stats["rounds"] % len(sig)] ^= 0x01
        return self.T.SCPEnvelope.make(statement=env.statement,
                                       signature=bytes(sig))

    def deliver_round(self) -> None:
        batch, self.outbox = self.outbox, []
        forged = self._forged(batch[self.stats["rounds"] % len(batch)][1])
        triples = [self.sig_triple(env) for _, env in batch]
        triples.append(self.sig_triple(forged))
        verdicts = [bool(v) for v in self.verify(triples)]
        if not all(verdicts[:-1]) or verdicts[-1]:
            raise AssertionError(f"signature verdicts {verdicts}")
        for d in self.drivers:
            d.prime_sig_verdicts(zip(triples, verdicts))
        for sender, env in batch:
            self.emitted.append((sender, self.T.SCPEnvelope.encode(env)))
            for i, node in enumerate(self.nodes):
                if i != sender:
                    node.receive_envelope(env)
        invalid = self.S.EnvelopeState.INVALID
        for node in self.nodes:
            if node.receive_envelope(forged) != invalid:
                raise AssertionError("a forged envelope was accepted")
            self.stats["forged_refused"] += 1
        self.stats["rounds"] += 1
        self.stats["envelopes"] += len(batch)
        self.stats["batch_sizes"].append(len(triples))

    def fire_timers(self) -> None:
        self.now = min(t for t, _ in self.timers.values())
        due = sorted(k for k, (t, _) in self.timers.items() if t == self.now)
        for key in due:
            entry = self.timers.pop(key, None)
            if entry is not None:
                self.stats["timers_fired"] += 1
                entry[1]()

    def run_slot(self, slot: int, prev: bytes) -> bytes:
        """Every node nominates its own value for ``slot``; deliver and
        fire timers until every node externalized, then drain the bus.
        Returns the common value (raises if the nodes disagree)."""
        for i, node in enumerate(self.nodes):
            node.nominate(slot, self.sha256(b"value-%d-%d" % (slot, i)), prev)
        done = self.externalized.setdefault(slot, {})
        while len(done) < len(self.nodes) or self.outbox:
            if self.stats["rounds"] >= MAX_ROUNDS:
                raise AssertionError(f"slot {slot} did not externalize")
            if self.outbox:
                self.deliver_round()
            elif self.timers:
                self.fire_timers()
            else:
                raise AssertionError(f"slot {slot} stalled")
        for key in [k for k in self.timers if k[1] == slot]:
            del self.timers[key]
        values = set(done.values())
        if len(values) != 1:
            raise AssertionError(f"slot {slot} externalized {len(values)} "
                                 "different values")
        return values.pop()


def fba_xdr_qset(make_qset, node_ids, org_size=ORG_SIZE, top_thr=TOP_THR,
                 inner_thr=INNER_THR):
    """``fba_topology()`` as an XDR qset over ``node_ids``: every org of
    ``org_size`` consecutive nodes one inner set of ``inner_thr``, and
    ``top_thr`` of the inner sets."""
    orgs = [node_ids[o:o + org_size] for o in range(0, len(node_ids),
                                                    org_size)]
    return make_qset(top_thr, [], [make_qset(inner_thr, org) for org in orgs])


def batch_verifier(verify_batch, pad, device, sizes: list):
    """``Network.verify`` through ``verify_batch`` on ``device``: one call
    per round, the batch padded to ``pad(n)`` rows by repeating rows as
    the overlay does; appends each padded size to ``sizes``."""
    from stellar_core_tpu_torch.utils.device import signature_columns

    def verify(triples):
        n = len(triples)
        cols = signature_columns(triples)
        idx = np.arange(pad(n)) % n
        sizes.append(idx.size)
        ok = verify_batch(*(torch.as_tensor(c[idx], device=device)
                            for c in cols))
        return ok[:n].cpu().tolist()
    return verify


def run_scp(scp_pkg, types, ref, sha256, verify, n_slots, device,
            n_orgs=N_ORGS, org_size=ORG_SIZE, top_thr=TOP_THR,
            inner_thr=INNER_THR):
    """A ``Network`` of ``n_orgs * org_size`` port validators, node ids
    the ed25519 public keys of seeded secrets, every node with
    ``tally_backend="both"`` on ``device``; nominates and externalizes
    ``n_slots`` slots.  Returns (network, values, seconds per slot)."""
    rng = np.random.default_rng(SEED)
    seeds = [rng.bytes(32) for _ in range(n_orgs * org_size)]
    net = Network(scp_pkg, types, seeds,
                  functools.partial(fba_xdr_qset, org_size=org_size,
                                    top_thr=top_thr, inner_thr=inner_thr),
                  ref.sign, ref.public_from_seed, sha256, verify,
                  scp_kwargs={"tally_backend": "both", "device": device})
    values, seconds, prev = [], [], bytes(32)
    for slot in range(1, n_slots + 1):
        t0 = time.perf_counter()
        prev = net.run_slot(slot, prev)
        seconds.append(time.perf_counter() - t0)
        values.append(prev)
    return net, values, seconds


# -- quorum-intersection networks --------------------------------------------

def clique_ids(n: int) -> list:
    """Node ids of the quorum tier bench's cliques."""
    return [b"%02d" % i + b"\x00" * 30 for i in range(n)]


def twisted_clique(make_qset, node_ids) -> dict:
    """The quorum tier bench's twisted majority clique: node i lists every
    node but node i + 1 (cyclically) with threshold 2n/3 + 1, so that no
    two members share a qset and the org reduction cannot fire."""
    n = len(node_ids)
    thr = 2 * n // 3 + 1
    qmap = {}
    for i, x in enumerate(node_ids):
        members = [v for j, v in enumerate(node_ids) if j != (i + 1) % n]
        qmap[x] = make_qset(min(thr, len(members)), members, [])
    return qmap


def tiered_orgs(make_qset, node_ids, top_thr, n_core=QI_CORE_ORGS,
                listed=QI_LISTED, org_size=ORG_SIZE,
                inner_thr=INNER_THR) -> dict:
    """Orgs of ``org_size`` consecutive nodes, each an inner set of
    ``inner_thr``; the last ``n_core`` orgs are the core, which every node
    lists.  Every qset lists ``listed`` orgs (at most 1,000 validators,
    the most a sane qset holds) and needs ``top_thr`` of them: a core node
    the core and the first other orgs; member j of another org o the core,
    its own org and the orgs that follow o + j, so that the members of an
    org differ and the org reduction cannot fire."""
    n_orgs = len(node_ids) // org_size
    orgs = [make_qset(inner_thr, node_ids[o * org_size:(o + 1) * org_size])
            for o in range(n_orgs)]
    outer = n_orgs - n_core
    core = orgs[outer:]
    qmap = {}
    for o in range(n_orgs):
        for j in range(org_size):
            if o >= outer:
                lists = core + orgs[:listed - n_core]
            else:
                lists = core + [orgs[o]] + [
                    orgs[(o + d) % outer]
                    for d in range(1 + j, listed - n_core + j)]
            qmap[node_ids[o * org_size + j]] = make_qset(top_thr, [], lists)
    return qmap


def qi_result(res, seconds) -> dict:
    return {"ok": res.ok, "scanned": res.scanned, "aborted": res.aborted,
            "tier": res.tier, "scc_size": res.scc_size, "seconds": seconds,
            "subproblems_per_s": res.scanned / seconds if seconds else None}


def run_qi(qi, qmap, **kw):
    """``check_quorum_intersection(qmap, **kw)`` on the host clock."""
    t0 = time.perf_counter()
    res = qi.check_quorum_intersection(qmap, **kw)
    return res, time.perf_counter() - t0


def check_split(qi, local_node, qmap, res) -> dict:
    """The two quorums of a split verdict: each a quorum (``_contract_host``
    keeps it whole and every member's slice is in it), and disjoint."""
    a, b = res.split
    for side in (a, b):
        if not side or qi._contract_host(side, qmap) != side or not all(
                local_node.is_quorum_slice(qmap[x], side) for x in side):
            raise AssertionError("a side of the split is not a quorum")
    if a & b:
        raise AssertionError("the split's quorums intersect")
    return {"quorum_sizes": [len(a), len(b)], "disjoint": True}


def quorum_intersection_phase(net, dev) -> list:
    """The ``quorum_intersection`` phase's three networks; returns the
    lines to print.  Raises on any failed check."""
    from stellar_core_tpu_torch import native
    from stellar_core_tpu_torch.herder import quorum_intersection as QI
    from stellar_core_tpu_torch.herder.quorum_tracker import QuorumTracker
    from stellar_core_tpu_torch.ops import quorum as Q
    from stellar_core_tpu_torch.scp import local_node as LN
    from stellar_core_tpu_torch.tools.contractor_probe import ContractorProbe

    t0 = time.perf_counter()
    native.get_lib()       # g++, outside the native tier's timed scans
    lines = [{"phase": "quorum_intersection", "native_build_seconds":
              time.perf_counter() - t0}]
    tiers = (("native", {"use_native": True, "use_device": False}),
             ("numpy", {"use_native": False, "use_device": False}),
             ("device", {"use_native": False, "use_device": True,
                         "device": dev}))
    # (a) BASELINE config #3: the twisted majority cliques
    for n in QI_CLIQUES:
        qmap = twisted_clique(LN.make_qset, clique_ids(n))
        row = {"phase": "quorum_intersection", "network": "clique",
               "scc_size": n}
        for label, kw in tiers:
            with ContractorProbe(QI, Q) as probe:
                res, secs = run_qi(QI, qmap, max_seconds=QI_MAX_SECONDS,
                                   **kw)
            row[label] = qi_result(res, secs)
            if label == "device":
                row[label]["probe"] = probe.stats()
                if probe.mismatches or probe.devices != {str(dev)}:
                    raise AssertionError(f"device chunks: {probe.stats()}")
            if res.aborted:
                if res.ok is not None:
                    raise AssertionError(f"{label} aborted with a verdict")
            elif res.ok is not True or res.scanned != QI_CLIQUE_SCANNED[n] \
                    or res.tier != label:
                raise AssertionError(f"{label} at {n} nodes: ok={res.ok}, "
                                     f"scanned={res.scanned}, {res.tier}")
        lines.append(row)

    # (b) the live network as node 0's tracker sees it
    qsets = {d.node_id: net.qset for d in net.drivers}
    tracker = QuorumTracker(net.drivers[0].node_id, net.qset)
    tracker.rebuild(qsets.get, net.qset)
    qmap = tracker.qset_map()
    if set(qmap) != set(qsets):
        raise AssertionError("the tracker does not see every validator")
    row = {"phase": "quorum_intersection", "network": "live",
           "validators": len(qmap)}
    for label, kw, want in (("default", {}, "org:native"),
                            ("no_native", {"use_native": False},
                             "org:device")):
        with ContractorProbe(QI, Q) as probe:
            res, secs = run_qi(QI, qmap, **kw)
        row[label] = qi_result(res, secs)
        row[label]["probe"] = probe.stats()
        if res.ok is not True or res.tier != want or probe.mismatches:
            raise AssertionError(f"live network, {label}: ok={res.ok}, "
                                 f"{res.tier}, {probe.stats()}")
        if want == "org:device" and probe.devices != {str(dev)}:
            raise AssertionError(f"org:device ran on {probe.devices}")
    lines.append(row)

    # (c) past the native ceiling: 1,040 nodes, default routing
    ids = [i.to_bytes(32, "big") for i in range(QI_ORGS * ORG_SIZE)]
    for label, top_thr in (("wide", 2 * QI_LISTED // 3 + 1), ("wide_split",
                                                              2)):
        t0 = time.perf_counter()
        qmap = tiered_orgs(LN.make_qset, ids, top_thr)
        build_s = time.perf_counter() - t0
        declined = []
        real_native = QI._check_native

        def native(contractor, *args):
            t1 = time.perf_counter()
            out = real_native(contractor, *args)
            declined.append((out is None, time.perf_counter() - t1))
            return out

        torch.cuda.reset_peak_memory_stats()
        QI._check_native = native
        try:
            with ContractorProbe(QI, Q) as probe:
                res, secs = run_qi(QI, qmap, max_calls=QI_MAX_CALLS)
        finally:
            QI._check_native = real_native
        row = {"phase": "quorum_intersection", "network": label,
               "nodes": len(qmap), "top_threshold": top_thr,
               "listed_orgs": QI_LISTED, "max_calls": QI_MAX_CALLS,
               "build_seconds": build_s, "native_declined": declined,
               **qi_result(res, secs), "probe": probe.stats(),
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if not probe.chunk_ms or probe.mismatches or \
                [d for d, _ in declined] != [True] \
                or res.tier != "device" or res.scc_size != len(qmap):
            raise AssertionError(f"{label}: {row}")
        if label == "wide":
            if res.ok is not None or not res.aborted:
                raise AssertionError(f"wide: ok={res.ok}, aborted="
                                     f"{res.aborted} under the budget")
        else:
            if res.ok is not False or res.aborted:
                raise AssertionError(f"wide_split: ok={res.ok}")
            row["split"] = check_split(QI, LN, qmap, res)
        lines.append(row)
    return lines


# -- the standalone node (BASELINE config #1) ---------------------------------

class Account:
    """A port node's account: a keypair whose next sequence number is read
    from the node's ledger, with the op and envelope builders of
    ``tests/txtest.py``'s ``TestAccount`` that a node's traffic needs."""

    def __init__(self, app, secret):
        self.app, self.secret = app, secret
        self.account_id = secret.public_key().raw

    @classmethod
    def root(cls, app) -> "Account":
        """The genesis root account, whose seed is the network id."""
        from stellar_core_tpu_torch.crypto import SecretKey
        return cls(app, SecretKey(app.config.network_id()))

    @classmethod
    def named(cls, app, name: bytes) -> "Account":
        from stellar_core_tpu_torch.crypto import SecretKey, sha256
        return cls(app, SecretKey(sha256(name)))

    def next_seq(self) -> int:
        from stellar_core_tpu_torch.ledger import LedgerTxn
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            entry = ltx.load_account(self.account_id)
            ltx.rollback()
        return (entry.data.value.seqNum if entry is not None else 0) + 1

    def op_create_account(self, dest: bytes, balance: int):
        from stellar_core_tpu_torch.xdr import types as T
        return T.Operation.make(sourceAccount=None, body=T.OperationBody.make(
            T.OperationType.CREATE_ACCOUNT, T.CreateAccountOp.make(
                destination=T.account_id(dest), startingBalance=balance)))

    def op_payment(self, dest: bytes, amount: int):
        from stellar_core_tpu_torch.transactions import utils as U
        from stellar_core_tpu_torch.xdr import types as T
        return T.Operation.make(sourceAccount=None, body=T.OperationBody.make(
            T.OperationType.PAYMENT, T.PaymentOp.make(
                destination=T.muxed_account(dest), asset=U.asset_native(),
                amount=amount)))

    def tx(self, ops, fee=None, seq=None):
        """A v1 envelope of ``ops`` signed by this account's key."""
        from stellar_core_tpu_torch.crypto import sha256
        from stellar_core_tpu_torch.transactions.signature_checker import \
            signature_hint
        from stellar_core_tpu_torch.xdr import types as T
        tx = T.Transaction.make(
            sourceAccount=T.muxed_account(self.account_id),
            fee=fee if fee is not None else 100 * len(ops),
            seqNum=seq if seq is not None else self.next_seq(),
            cond=T.Preconditions.make(T.PreconditionType.PRECOND_NONE),
            memo=T.MEMO_NONE_VALUE, operations=ops,
            ext=T.Transaction.fields[6][1].make(0))
        payload = T.TransactionSignaturePayload.make(
            networkId=self.app.config.network_id(),
            taggedTransaction=T.TransactionSignaturePayload.fields[1][1].make(
                T.EnvelopeType.ENVELOPE_TYPE_TX, tx))
        h = sha256(T.TransactionSignaturePayload.encode(payload))
        sig = T.DecoratedSignature.make(hint=signature_hint(self.account_id),
                                        signature=self.secret.sign(h))
        return T.TransactionEnvelope.make(
            T.EnvelopeType.ENVELOPE_TYPE_TX,
            T.TransactionV1Envelope.make(tx=tx, signatures=[sig]))


def forge_envelope(env):
    """A copy of ``env`` with one flipped byte in its first signature."""
    from stellar_core_tpu_torch.xdr import types as T
    v1 = env.value
    ds = v1.signatures[0]
    sig = bytearray(ds.signature)
    sig[7] ^= 0x01
    forged = T.DecoratedSignature.make(hint=ds.hint, signature=bytes(sig))
    return T.TransactionEnvelope.make(
        T.EnvelopeType.ENVELOPE_TYPE_TX, T.TransactionV1Envelope.make(
            tx=v1.tx, signatures=[forged] + list(v1.signatures[1:])))


def node_app(crypto_backend: str, device=None, max_tx_set=NODE_ACCOUNTS,
             **config_kw):
    """A started port standalone node (``test_config``: MANUAL_CLOSE, an
    in-memory database, the virtual clock) with the node's default
    parallel apply, pipelined close, invariants and native settings and
    ``max_tx_set`` operations a ledger (``config_kw``: further settings).
    ``crypto_backend="cuda"`` runs the close's signature batch and the SCP
    tallies on ``device``; ``"cpu"`` is the host reference node."""
    from stellar_core_tpu_torch.main import Application, Config, test_config
    from stellar_core_tpu_torch.utils.clock import ClockMode, VirtualClock

    node_defaults = Config()
    cfg = test_config(
        CRYPTO_BACKEND=crypto_backend,
        SCP_TALLY_BACKEND="tensor" if crypto_backend == "cuda" else "host",
        TESTING_UPGRADE_MAX_TX_SET_SIZE=max_tx_set,
        PARALLEL_APPLY_WORKERS=node_defaults.PARALLEL_APPLY_WORKERS,
        PIPELINED_CLOSE=node_defaults.PIPELINED_CLOSE,
        INVARIANT_CHECKS=node_defaults.INVARIANT_CHECKS, **config_kw)
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                      device=device)
    app.start()
    return app


def close_results(app) -> list:
    """(result code name, fee charged) of every tx of the last close, in
    apply order, from its ``LedgerCloseMeta``."""
    from stellar_core_tpu_torch.xdr import types as T
    codes = T.TransactionResultCode
    return [(codes.nameof(m.result.result.result.type),
             m.result.result.feeCharged)
            for m in app._meta_stream[-1].value.txProcessing]


def node_state(app, types) -> dict:
    """The last close's ledger hash, bucket-list hash, ``LedgerCloseMeta``
    bytes and tx-history rows, of either package's node (``types`` is
    that package's ``xdr.types``)."""
    lm = app.ledger_manager
    return {
        "ledger_hash": lm.last_closed_hash(),
        "bucket_list_hash": app.bucket_manager.get_bucket_list_hash(),
        "meta": types.LedgerCloseMeta.encode(app._meta_stream[-1]),
        "txhistory": app.database.execute(
            "SELECT txid, ledgerseq, txindex, txbody, txresult, txmeta "
            "FROM txhistory WHERE ledgerseq=? ORDER BY txindex",
            (lm.last_closed_seq(),)).fetchall(),
    }


def close_peer_set(app, types, set_cls, data_cls, envs):
    """Close a peer's tx set of ``envs`` on ``app`` through
    ``close_ledger``, as a set that arrived from the wire
    (``make_from_wire``: no admission filter), with the next close time;
    either package's node, given that package's ``xdr.types``,
    ``TxSetFrame`` and ``LedgerCloseData``.  Returns the set."""
    lm = app.ledger_manager
    lcl = lm.last_closed_header()
    tx_set = set_cls.make_from_wire(
        app.config.network_id(), types.TransactionSet.make(
            previousLedgerHash=lm.last_closed_hash(), txs=envs))
    sv = types.StellarValue.make(
        txSetHash=tx_set.contents_hash(),
        closeTime=lcl.scpValue.closeTime + 1, upgrades=[],
        ext=types.StellarValue.fields[3][1].make(
            types.StellarValueType.STELLAR_VALUE_BASIC))
    lm.close_ledger(data_cls(lcl.ledgerSeq + 1, tx_set, sv))
    app.herder.ledger_closed(lcl.ledgerSeq + 1)
    return tx_set


class CloseProbe:
    """Counts, per close of node A, what its signature batch did: the
    calls of the verify wrapper ``ops/ed25519_cuda.verify_batch`` with
    their rows (the last call's inputs kept for a replay), the distinct
    (pubkey, sig, msg) triples the batch's verdicts answered, and the
    host ``verify_sig`` calls (verdicts that did not come from the batch).
    Counts only inside ``app.ledger_manager.close_ledger``."""

    def __init__(self, app):
        from stellar_core_tpu_torch import crypto
        from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
        from stellar_core_tpu_torch.ops import ed25519_cuda
        self.app, self.crypto, self.ops = app, crypto, ed25519_cuda
        self.txset_cls = TxSetFrame
        self.last_batch = None
        self._saved: dict = {}
        self.reset()

    def reset(self) -> None:
        self.batches: list = []      # padded rows of each wrapper call
        self.answered: set = set()
        self.host_verifies = 0

    def _close(self, real):
        def close_ledger(close_data):
            crypto, ops, cls = self.crypto, self.ops, self.txset_cls
            real_verify, real_batch = crypto.verify_sig, ops.verify_batch
            real_cached = cls.make_cached_verify

            def verify_sig(*args):
                self.host_verifies += 1
                return real_verify(*args)

            def verify_batch(pk, sg, mg, *args):
                self.batches.append(int(pk.shape[0]))
                self.last_batch = (pk, sg, mg)
                return real_batch(pk, sg, mg, *args)

            def make_cached_verify(tx_set, verdicts):
                fallback = real_cached(tx_set, verdicts)

                def verify(pub, sig, msg):
                    if (pub, sig, msg) in verdicts:
                        self.answered.add((pub, sig, msg))
                    return fallback(pub, sig, msg)
                return verify

            crypto.verify_sig, ops.verify_batch = verify_sig, verify_batch
            cls.make_cached_verify = make_cached_verify
            try:
                return real(close_data)
            finally:
                crypto.verify_sig, ops.verify_batch = real_verify, real_batch
                cls.make_cached_verify = real_cached
        return close_ledger

    def __enter__(self):
        lm = self.app.ledger_manager
        lm.close_ledger = self._close(lm.close_ledger)
        return self

    def __exit__(self, *exc):
        del self.app.ledger_manager.close_ledger


def close_phases(app) -> dict:
    """ms of each phase of the last close, and the verify phase's
    dispatch / host-wait split from the tracer's spans."""
    phases = app.ledger_manager.last_close_phases
    out = {k: phases.get(k) for k in NODE_PHASES}
    rec = app.tracer.get_close()
    for sp in rec.spans if rec is not None else ():
        if sp.name in ("crypto.sigbatch.dispatch", "crypto.sigbatch.host_wait"):
            key = sp.name.rsplit(".", 1)[1] + "_ms"
            out[key] = out.get(key, 0.0) + sp.seconds * 1e3
    return out


def run_node(device, n_accounts=NODE_ACCOUNTS, payment_closes=NODE_CLOSES,
             forge_every=NODE_FORGE_EVERY, emit_line=None) -> dict:
    """BASELINE config #1 on the port alone: node A (``CRYPTO_BACKEND=
    "cuda"`` on ``device``, tallies ``"tensor"``) and node B (``"cpu"``,
    ``"host"``) from genesis.  The root creates ``n_accounts`` accounts in
    transactions of ``NODE_CREATE_OPS`` CREATE_ACCOUNT ops, in one close;
    then ``payment_closes`` closes of one payment per account (account i
    to i + 1, one signature each) go through ``recv_transaction`` and
    ``manual_close()``; last, a tx set of one payment per account with
    every ``forge_every``-th signature forged is closed through
    ``close_ledger`` as a peer's set would be (``make_from_wire``).  Both
    nodes get the same envelopes.  Checks after every close: A's batch
    went through the verify wrapper once, with one row per signature
    padded to a ``SIG_BATCH_BUCKETS`` size, its verdicts answered every
    triple and no signature was verified on the host; every payment is
    ``txSUCCESS``, every forged one ``txBAD_AUTH`` with its fee charged;
    A and B agree in ledger hash, bucket-list hash and meta bytes.
    ``emit_line`` gets one dict a close.  Returns the run's numbers."""
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.transactions.frame import \
        tx_frame_from_envelope
    from stellar_core_tpu_torch.utils.device import pad_signature_batch
    from stellar_core_tpu_torch.xdr import types as T

    emit_line = emit_line or (lambda line: None)
    a, b = node_app("cuda", device), node_app("cpu")
    on_card = a.device.type == "cuda"
    if a.ledger_manager.last_closed_hash() != \
            b.ledger_manager.last_closed_hash():
        raise AssertionError("the nodes' genesis ledgers differ")
    probe = CloseProbe(a)
    out = {"closes": [], "launches": 0}
    t0 = time.perf_counter()
    accounts = [Account.named(a, b"node-account-%d" % i)
                for i in range(n_accounts)]
    keygen_s = time.perf_counter() - t0

    def submit(envs) -> float:
        pending = TransactionQueue.ADD_STATUS_PENDING
        t0 = time.perf_counter()
        got = [a.herder.recv_transaction(env) for env in envs]
        admit_s = time.perf_counter() - t0
        if got != [pending] * len(envs) or \
                [b.herder.recv_transaction(env) for env in envs] != got:
            raise AssertionError(f"admission statuses: {got}")
        return admit_s

    def close(kind, n_txs, want, close_fn, **timing) -> None:
        probe.reset()
        launches0 = ed25519_cuda.launches
        t0 = time.perf_counter()
        close_fn(a)
        if on_card:
            torch.cuda.synchronize()
        close_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        close_fn(b)
        b_close_s = time.perf_counter() - t0
        launches = ed25519_cuda.launches - launches0
        rows = len(probe.answered)
        results = close_results(a)
        if [code for code, _ in results] != want:
            raise AssertionError(f"{kind} close: results {results}")
        if any(fee <= 0 for _, fee in results):
            raise AssertionError(f"{kind} close: a tx was not charged")
        if probe.batches != [pad_signature_batch(n_txs)] or \
                rows != n_txs or probe.host_verifies or \
                launches != (1 if on_card else 0):
            raise AssertionError(
                f"{kind} close: batches {probe.batches}, {launches} "
                f"launches, {rows} triples answered, "
                f"{probe.host_verifies} host verifies")
        if node_state(a, T) != node_state(b, T):
            raise AssertionError(f"{kind} close: node A differs from the "
                                 "cpu-backend node B")
        out["launches"] += launches
        line = {"phase": "node", "close": len(out["closes"]) + 1,
                "kind": kind, "seq": a.ledger_manager.last_closed_seq(),
                "txs": n_txs, "triples": rows, "padded": probe.batches[0],
                "launches": launches, "host_verifies": probe.host_verifies,
                "results": dict(collections.Counter(c for c, _ in results)),
                "phases_ms": close_phases(a), "close_seconds": close_s,
                "node_b_close_seconds": b_close_s, **timing,
                "equal_to_cpu_node": True}
        out["closes"].append(line)
        emit_line(line)

    with probe:
        root = Account.root(a)
        seq = root.next_seq()
        t0 = time.perf_counter()
        envs = [root.tx([root.op_create_account(acct.account_id, 10**10)
                         for acct in accounts[i:i + NODE_CREATE_OPS]],
                        seq=seq + k)
                for k, i in enumerate(range(0, n_accounts, NODE_CREATE_OPS))]
        sign_s = time.perf_counter() - t0
        admit_s = submit(envs)
        close("seed", len(envs), ["txSUCCESS"] * len(envs),
              lambda app: app.herder.manual_close(), sign_seconds=sign_s,
              admission_seconds=admit_s, keygen_seconds=keygen_s)

        def payments():
            return [acct.tx([acct.op_payment(
                accounts[(i + 1) % n_accounts].account_id, 1 + i)])
                for i, acct in enumerate(accounts)]

        for _ in range(payment_closes):
            t0 = time.perf_counter()
            envs = payments()
            sign_s = time.perf_counter() - t0
            admit_s = submit(envs)
            close("payments", n_accounts, ["txSUCCESS"] * n_accounts,
                  lambda app: app.herder.manual_close(),
                  sign_seconds=sign_s, admission_seconds=admit_s)

        envs = payments()
        forged = set(range(forge_every - 1, n_accounts, forge_every))
        envs = [forge_envelope(env) if i in forged else env
                for i, env in enumerate(envs)]

        # the results in apply order: a forged signature leaves the tx's
        # hash as it was
        net_id = a.config.network_id()
        bad = {tx_frame_from_envelope(net_id, envs[i]).full_hash()
               for i in forged}
        order = TxSetFrame.make_from_wire(net_id, T.TransactionSet.make(
            previousLedgerHash=a.ledger_manager.last_closed_hash(),
            txs=envs)).txs_in_apply_order()
        want = ["txBAD_AUTH" if f.full_hash() in bad else "txSUCCESS"
                for f in order]
        close("forged", n_accounts, want, lambda app: close_peer_set(
            app, T, TxSetFrame, LedgerCloseData, envs))
    out.update(forged=len(forged), accounts=n_accounts,
               last_batch=probe.last_batch, apps=(a, b))
    return out


def node_phase(card_line: str, dev) -> int:
    """The ``node`` phase: builds the port's native libraries, runs
    ``run_node`` at BASELINE config #1's size with node A on ``dev`` (the
    verify kernel's launches counted from 0), holds the kernel against its
    plain version on one close's batch and replays it by CUDA events, and
    checks that every native library built and served
    the closes (the native fee batch, the apply kernel, the tail encode
    and the bucket merges).  Prints its lines; returns the launches.
    Raises on any failed check."""
    from stellar_core_tpu_torch import native
    from stellar_core_tpu_torch.bucket import bucket_list as BL
    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
    from stellar_core_tpu_torch.xdr import types as T

    t0 = time.perf_counter()
    native.get_lib()
    native.get_xdrpack()
    native.get_apply_kernel()
    emit({"phase": "node", "card": card_line,
          "native_build_seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in native.BUILD_DIR.glob("*.so")),
          "accounts": NODE_ACCOUNTS, "txs_per_close": NODE_ACCOUNTS,
          "payment_closes": NODE_CLOSES, "forge_every": NODE_FORGE_EVERY})
    merges: list = []
    real_merge = BL._native_merge

    def merge(newer, older):
        out = real_merge(newer, older)
        merges.append(out is not None)
        return out

    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    BL._native_merge = merge
    try:
        run = run_node(dev, emit_line=emit)
    finally:
        BL._native_merge = real_merge
    launches = ed25519_cuda.launches
    if launches != len(run["closes"]):
        raise AssertionError(f"{launches} verify launches for "
                             f"{len(run['closes'])} closes")
    a = run["apps"][0]
    counters = {name: a.metrics.counter(name).count for name in (
        "apply.native.hit", "apply.native.decline", "apply.native.fee.hit",
        "apply.native.tail_encode.hit")}
    counters["bucket.native_merges"] = sum(merges)
    if not T.NATIVE_ENCODE or not all(counters[k] for k in (
            "apply.native.hit", "apply.native.fee.hit",
            "apply.native.tail_encode.hit", "bucket.native_merges")):
        raise AssertionError(f"a native library did not serve the closes: "
                             f"encoder {T.NATIVE_ENCODE}, {counters}")
    # the kernel against its plain version on the node's own last batch
    # (the forged close's): these launches come after the count was read
    batch = run["last_batch"]
    got = ed25519_cuda.verify_batch(*batch)
    want = ed25519_kernel.verify_batch(*batch)
    if not torch.equal(got, want):
        raise AssertionError(
            f"the kernel differs from the plain version on the node's batch "
            f"in {int((got != want).sum())} of {got.shape[0]} rows")
    kernel_ms = cuda_ms(lambda: ed25519_cuda.verify_batch(*batch))
    totals = [c["phases_ms"]["total"] for c in run["closes"]
              if c["kind"] != "seed"]
    emit({"phase": "node", "accounts": run["accounts"],
          "closes": len(run["closes"]), "launches": launches,
          "forged": run["forged"], "native": counters,
          "kernel_ms_replayed": kernel_ms,
          "kernel_rows_replayed": int(batch[0].shape[0]),
          "kernel_equal_to_plain_on_batch": True,
          "batch_rows_false": int((~want).sum()),
          "busy_share_of_close": [kernel_ms / t for t in totals],
          "equal_to_cpu_node": True})
    return launches


# -- catchup replay (BASELINE config #4) -------------------------------------

class ReplayProbe(CloseProbe):
    """``CloseProbe`` over every close of a catchup's replay: one record a
    close (its seq, the wrapper's calls with their padded rows, the
    triples its verdicts answered, host verifies, the kernel's launches by
    its own count, the phases' ms and the close's seconds); the results
    and the batch of the close of ``watch_seq`` are kept."""

    def __init__(self, app, watch_seq: int):
        super().__init__(app)
        self.watch_seq = watch_seq
        self.records: list = []
        self.watch_results = self.watch_batch = None

    def _close(self, real):
        inner = super()._close(real)

        def close_ledger(close_data):
            self.reset()
            launches0 = self.ops.launches
            t0 = time.perf_counter()
            out = inner(close_data)
            seconds = time.perf_counter() - t0
            seq = close_data.ledger_seq
            self.records.append({
                "seq": seq, "batches": list(self.batches),
                "triples": len(self.answered),
                "host_verifies": self.host_verifies,
                "launches": self.ops.launches - launches0,
                "phases_ms": close_phases(self.app), "seconds": seconds})
            if seq == self.watch_seq:
                self.watch_results = close_results(self.app)
                self.watch_batch = self.last_batch if self.batches else None
            return out
        return close_ledger


def run_catchup(device, archive_dir: str, n_accounts=NODE_ACCOUNTS,
                payment_ledgers=CATCHUP_PAYMENT_LEDGERS,
                forge_every=NODE_FORGE_EVERY, checkpoints=CATCHUP_CHECKPOINTS,
                minimal_to=None, emit_line=None) -> dict:
    """BASELINE config #4, the herder's ledger-close replay of a catchup
    history range, on the port.  A standalone ``cpu``-backend publisher
    (``node_app``, the accelerated test config's checkpoints of 8 ledgers)
    publishes to a local archive in ``archive_dir``: one ledger in which
    the root creates ``n_accounts`` accounts (transactions of
    ``NODE_CREATE_OPS`` ops), ``payment_ledgers`` ledgers of one payment
    per account through ``recv_transaction`` and ``manual_close()``, a
    peer's set of one payment per account with every ``forge_every``-th
    signature forged through ``close_ledger`` (``make_from_wire``), then
    empty ledgers up to the end of checkpoint ``checkpoints``.  Three cold
    nodes catch up from the archive through ``CatchupWork``: A complete on
    ``CRYPTO_BACKEND="cuda"`` with ``device``, B complete on ``"cpu"``, C
    minimal on ``"cuda"`` to ``minimal_to`` (default the forged ledger:
    buckets at the checkpoint before it, then the replay of the rest),
    each with the process's host verify cache emptied first, as a fresh
    node's is.
    Checks: each joiner's stored header hashes and bucket-list hashes equal
    the publisher's at every seq they share, and its live bucket list the
    publisher's at its last ledger; on ``"cuda"`` every replayed ledger
    with signatures is one wrapper call on its ``SIG_BATCH_BUCKETS`` size
    whose verdicts answer every signature (one kernel launch on a CUDA
    device, the plain version on a CPU one), with no host verify, and every
    other replayed ledger none; on ``"cpu"`` no wrapper call; A's and B's
    results of the forged ledger equal the publisher's.  ``emit_line``
    gets one dict for the publisher and one a joiner.  Returns the run's
    numbers."""
    from stellar_core_tpu_torch.catchup import (CatchupConfiguration,
                                                CatchupWork)
    from stellar_core_tpu_torch.crypto import ed25519 as ed
    from stellar_core_tpu_torch.crypto import sha256
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    from stellar_core_tpu_torch.herder.tx_set import TxSetFrame
    from stellar_core_tpu_torch.history import HistoryArchive
    from stellar_core_tpu_torch.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.simulation.simulation import app_header_chain
    from stellar_core_tpu_torch.utils.device import pad_signature_batch
    from stellar_core_tpu_torch.work.work import State
    from stellar_core_tpu_torch.xdr import types as T

    emit_line = emit_line or (lambda line: None)
    archive = {"HISTORY_ARCHIVES": [("config4", archive_dir)]}
    pending = TransactionQueue.ADD_STATUS_PENDING
    t0 = time.perf_counter()
    pub = node_app("cpu", max_tx_set=n_accounts, **archive)
    lm = pub.ledger_manager
    last = checkpoints * pub.history_manager.checkpoint_frequency() - 1
    accounts = [Account.named(pub, b"node-account-%d" % i)
                for i in range(n_accounts)]
    sigs: dict = {}     # seq -> signatures of each ledger that has any

    def submit_and_close(envs) -> None:
        got = [pub.herder.recv_transaction(env) for env in envs]
        if got != [pending] * len(envs):
            raise AssertionError(f"publisher admission statuses: {got}")
        pub.herder.manual_close()
        sigs[lm.last_closed_seq()] = len(envs)

    root = Account.root(pub)
    seq = root.next_seq()
    submit_and_close([root.tx([root.op_create_account(acct.account_id, 10**10)
                               for acct in accounts[i:i + NODE_CREATE_OPS]],
                              seq=seq + k)
                      for k, i in enumerate(range(0, n_accounts,
                                                  NODE_CREATE_OPS))])

    def payments():
        return [acct.tx([acct.op_payment(
            accounts[(i + 1) % n_accounts].account_id, 1 + i)])
            for i, acct in enumerate(accounts)]

    for _ in range(payment_ledgers):
        submit_and_close(payments())
    forged = set(range(forge_every - 1, n_accounts, forge_every))
    envs = [forge_envelope(env) if i in forged else env
            for i, env in enumerate(payments())]
    close_peer_set(pub, T, TxSetFrame, LedgerCloseData, envs)
    forged_seq = lm.last_closed_seq()
    sigs[forged_seq] = len(envs)
    forged_results = close_results(pub)
    if [c for c, _ in forged_results].count("txBAD_AUTH") != len(forged):
        raise AssertionError(f"publisher's forged ledger: {forged_results}")
    while lm.last_closed_seq() < last:
        pub.herder.manual_close()
    has = HistoryArchive("config4", archive_dir).get_root_has()
    if lm.last_closed_seq() != last or has is None or \
            has.current_ledger != last:
        raise AssertionError(f"publisher at {lm.last_closed_seq()}, archive "
                             f"at {has and has.current_ledger}, not {last}")
    chain = app_header_chain(pub)
    out = {"publisher": {
        "phase": "catchup", "role": "publisher", "lcl": last,
        "checkpoints": checkpoints, "accounts": n_accounts,
        "signed_ledgers": sorted(sigs), "signatures": sigs,
        "forged_seq": forged_seq, "forged": len(forged),
        "seconds": time.perf_counter() - t0}, "joiners": {}}
    emit_line(out["publisher"])

    def join(tag: str, backend: str, mode: str, to: int) -> None:
        t0 = time.perf_counter()
        app = node_app(backend, device if backend == "cuda" else None,
                       max_tx_set=n_accounts,
                       NODE_SEED=sha256(b"catchup-joiner-" + tag.encode()),
                       **archive)
        work = CatchupWork(app, app.history_manager.archives[0],
                           CatchupConfiguration(to, mode))
        probe = ReplayProbe(app, forged_seq)
        launches0 = ed25519_cuda.launches
        # a cold node's host verify cache never saw the archived
        # signatures (this process's publisher verified them all)
        ed.clear_verify_cache()
        t1 = time.perf_counter()
        with probe:
            app.work_scheduler.schedule(work)
            while not work.done:
                if time.perf_counter() - t1 > CATCHUP_MAX_SECONDS:
                    raise AssertionError(f"joiner {tag} still catching up "
                                         f"after {CATCHUP_MAX_SECONDS} s")
                app.clock.set_current_virtual_time(app.clock.now() + 0.01)
                app.crank(block=False)
        catchup_s = time.perf_counter() - t1
        if work.state != State.SUCCESS or \
                app.ledger_manager.last_closed_seq() != to:
            raise AssertionError(f"joiner {tag}: {work.state.name} at "
                                 f"{app.ledger_manager.last_closed_seq()}")
        mine = app_header_chain(app)
        shared = sorted(mine.keys() & chain.keys())
        if to not in shared or any(mine[s] != chain[s] for s in shared) or \
                app.bucket_manager.get_bucket_list_hash() != chain[to][1]:
            raise AssertionError(f"joiner {tag} differs from the publisher")
        on_cuda = backend == "cuda"
        on_card = on_cuda and app.device.type == "cuda"
        for r in probe.records:
            n = sigs.get(r["seq"], 0)
            want = [pad_signature_batch(n)] if on_cuda and n else []
            if r["batches"] != want or \
                    r["launches"] != (len(want) if on_card else 0) or \
                    (on_cuda and (r["triples"] != n or r["host_verifies"])):
                raise AssertionError(f"joiner {tag}, replayed ledger: {r}")
        if forged_seq in {r["seq"] for r in probe.records} and \
                probe.watch_results != forged_results:
            raise AssertionError(f"joiner {tag}: the forged ledger's "
                                 f"results {probe.watch_results}")
        signed = [r for r in probe.records if r["seq"] in sigs]
        replayed = app.metrics.counter("catchup.ledger.replayed").count
        timer = app.metrics.timer("catchup.phase.replay")
        replay_s = timer.mean * timer.count
        verify_ms = [r["phases_ms"]["verify"] for r in signed]
        line = {"phase": "catchup", "role": "joiner", "joiner": tag,
                "mode": mode, "backend": backend,
                "device": str(app.device) if on_cuda else None,
                "to": to, "lcl": app.ledger_manager.last_closed_seq(),
                "replayed": replayed,
                "replayed_seqs": [probe.records[0]["seq"],
                                  probe.records[-1]["seq"]]
                if probe.records else [],
                "shared_seqs_equal": len(shared),
                "batches": [r["batches"] for r in signed],
                "launches": ed25519_cuda.launches - launches0,
                "host_verifies": sum(r["host_verifies"] for r in signed),
                "verify_cache_hits_misses": list(ed.verify_cache_stats()),
                "verify_ms": verify_ms,
                "verify_ms_median": float(np.median(verify_ms))
                if verify_ms else None,
                "phases_ms_median": {
                    k: float(np.median([r["phases_ms"][k] or 0.0
                                        for r in signed]))
                    for k in NODE_PHASES} if signed else None,
                "replay_seconds": replay_s,
                "replay_ledgers_per_s": replayed / replay_s
                if replay_s else None,
                "catchup_seconds": catchup_s,
                "build_seconds": t1 - t0,
                "forged_results": [c for c, _ in probe.watch_results]
                if probe.watch_results else None,
                "equal_to_publisher": True}
        emit_line(line)
        out["joiners"][tag] = dict(line, kept_batch=probe.watch_batch,
                                   app=app)

    join("A", "cuda", CatchupConfiguration.COMPLETE, last)
    join("B", "cpu", CatchupConfiguration.COMPLETE, last)
    join("C", "cuda", CatchupConfiguration.MINIMAL,
         forged_seq if minimal_to is None else minimal_to)
    return out


def catchup_phase(card_line: str, dev) -> int:
    """The ``catchup`` phase: ``run_catchup`` at BASELINE config #4's
    ledger width (1,000 payments a ledger) with joiners A and C on ``dev``,
    the verify kernel's launches counted from 0: each ``cuda`` joiner
    launches once a replayed ledger with signatures; the kernel held
    against its plain version on A's batch of the forged ledger, and that
    batch replayed by CUDA events.  Prints its lines; returns the
    launches.  Raises on any failed check."""
    import tempfile

    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel

    t0 = time.perf_counter()
    emit({"phase": "catchup", "card": card_line, "accounts": NODE_ACCOUNTS,
          "txs_per_ledger": NODE_ACCOUNTS,
          "payment_ledgers": CATCHUP_PAYMENT_LEDGERS,
          "forge_every": NODE_FORGE_EVERY,
          "checkpoints": CATCHUP_CHECKPOINTS,
          "reduced": {"range_ledgers": {
              "here": "3 checkpoints of 8 (the accelerated test config)",
              "real_checkpoint": 64, "r17_bench_range": 990}}})
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        run = run_catchup(dev, tmp, emit_line=emit)
    torch.cuda.synchronize()
    launches = ed25519_cuda.launches
    a, b, c = (run["joiners"][k] for k in "ABC")
    signed = run["publisher"]["signed_ledgers"]
    first, last = c["replayed_seqs"] or (0, -1)
    c_signed = [s for s in signed if first <= s <= last]
    if a["launches"] != len(signed) or c["launches"] != len(c_signed) or \
            launches != a["launches"] + c["launches"] or b["launches"]:
        raise AssertionError(f"{launches} verify launches: A {a['launches']}"
                             f", B {b['launches']}, C {c['launches']} for "
                             f"signed ledgers {signed}")
    if a["forged_results"] != b["forged_results"]:
        raise AssertionError("joiners A and B differ on the forged ledger")
    batch = a["kept_batch"]
    got = ed25519_cuda.verify_batch(*batch)
    want = ed25519_kernel.verify_batch(*batch)
    if not torch.equal(got, want):
        raise AssertionError(
            f"the kernel differs from the plain version on the forged "
            f"ledger's batch in {int((got != want).sum())} of "
            f"{got.shape[0]} rows")
    kernel_ms = cuda_ms(lambda: ed25519_cuda.verify_batch(*batch))
    plain_ms = cuda_ms(lambda: ed25519_kernel.verify_batch(*batch), reps=1)
    emit({"phase": "catchup", "card": card_line, "launches": launches,
          "launches_by_joiner": {k: run["joiners"][k]["launches"]
                                 for k in "ABC"},
          "padded_rows": sorted({r for j in (a, c) for rows in j["batches"]
                                 for r in rows}),
          "replay_ledgers_per_s": {k: run["joiners"][k]["replay_ledgers_per_s"]
                                   for k in "ABC"},
          "verify_ms_median": {k: run["joiners"][k]["verify_ms_median"]
                               for k in "ABC"},
          **{f"{name}_ms_median": {
              k: run["joiners"][k]["phases_ms_median"][name] for k in "ABC"}
             for name in ("total", "apply", "commit")},
          "forged_bad_auth": a["forged_results"].count("txBAD_AUTH"),
          "kernel_equal_to_plain_on_batch": True,
          "batch_rows_false": int((~want).sum()),
          "kernel_ms_replayed": kernel_ms, "plain_ms_replayed": plain_ms,
          "kernel_rows_replayed": int(batch[0].shape[0]),
          "equal_to_publisher": True,
          "publisher_seconds": run["publisher"]["seconds"],
          "seconds": time.perf_counter() - t0})
    return launches


# -- the network: 21 validators reach consensus over the loopback overlay ----

def settle(sim) -> None:
    """Crank a simulation's clock until a crank dispatches nothing; raises
    when it is still busy after ``NET_SETTLE_CRANKS`` cranks."""
    for _ in range(NET_SETTLE_CRANKS):
        if sim.crank() == 0:
            return
    raise AssertionError(
        f"the network did not settle in {NET_SETTLE_CRANKS} cranks")


def spread(xs) -> list:
    """[min, median, max] of ``xs`` ([] when empty)."""
    return [min(xs), float(np.median(xs)), max(xs)] if xs else []


class NetworkProbe:
    """Counts, while active, what a simulated network's two verify seams
    did, by wrapping ``OverlayManager._verify_triples`` (each node's
    per-crank SCP envelope batch) and ``LedgerManager.close_ledger`` (each
    close's signature batch), with the verify wrapper
    ``ops/ed25519_cuda.verify_batch`` wrapped inside them: per overlay
    batch its triples, whether all are well formed, the wrapper's launches
    (its own count) and padded rows; per close its launches; and the host
    seconds spent inside each seam (a batch's packing, copies, launch and
    readback, or its host verifies; a whole close).  The wrapper
    inputs of the overlay batch that held the triple of ``forged`` (a
    ``ForgedEnvelope``, or None) are kept for a replay, every distinct
    triple that a launched overlay batch carried, in order of arrival, and
    the false verdicts of those batches."""

    def __init__(self, forged):
        from stellar_core_tpu_torch.ledger.ledger_manager import LedgerManager
        from stellar_core_tpu_torch.ops import ed25519_cuda
        from stellar_core_tpu_torch.overlay.manager import OverlayManager
        self.ops = ed25519_cuda
        self.om_cls, self.lm_cls = OverlayManager, LedgerManager
        self.batches: list = []   # (triples, well formed, launches, padded)
        self.closes: list = []    # launches of each close
        self.verify_seconds = self.close_seconds = 0.0
        self.false_verdicts = 0   # of the triples of launched batches
        self.forged = forged
        self.kept = None
        self.triples: dict = {}   # distinct triples of launched batches
        self._inputs: list = []
        self._saved: dict = {}

    def _verify_batch(self, real):
        def verify_batch(pk, sg, mg, *args):
            self._inputs.append((pk, sg, mg))
            return real(pk, sg, mg, *args)
        return verify_batch

    def _verify_triples(self, real):
        def verify_triples(om, triples):
            launches0, self._inputs = self.ops.launches, []
            t0 = time.perf_counter()
            out = real(om, triples)
            self.verify_seconds += time.perf_counter() - t0
            well = all(len(t[0]) == 32 and len(t[1]) == 64 for t in triples)
            launches = self.ops.launches - launches0
            self.batches.append((len(triples), well, launches,
                                 [int(i[0].shape[0]) for i in self._inputs]))
            if launches:
                self.triples.update(dict.fromkeys(triples))
                self.false_verdicts += out.count(False)
            if self.forged is not None and self.forged.triple in triples \
                    and self._inputs:
                self.kept = self._inputs[-1]
            return out
        return verify_triples

    def _close_ledger(self, real):
        def close_ledger(lm, *args, **kw):
            launches0 = self.ops.launches
            t0 = time.perf_counter()
            out = real(lm, *args, **kw)
            self.close_seconds += time.perf_counter() - t0
            self.closes.append(self.ops.launches - launches0)
            return out
        return close_ledger

    def __enter__(self):
        self._saved = {(self.ops, "verify_batch"): self.ops.verify_batch,
                       (self.om_cls, "_verify_triples"):
                           self.om_cls._verify_triples,
                       (self.lm_cls, "close_ledger"): self.lm_cls.close_ledger}
        self.ops.verify_batch = self._verify_batch(self.ops.verify_batch)
        self.om_cls._verify_triples = self._verify_triples(
            self.om_cls._verify_triples)
        self.lm_cls.close_ledger = self._close_ledger(self.lm_cls.close_ledger)
        return self

    def __exit__(self, *exc):
        for (owner, name), real in self._saved.items():
            setattr(owner, name, real)


class ForgedEnvelope:
    """Injects, once, into one node's SCP inbox just before a drain during
    slot ``seq``, a copy of a peer's envelope of that slot (one whose quorum
    set and tx set the node already holds) with its signature zeroed, as
    ``tests/test_sigbatch.py`` does; records the verdict that the drain
    primed for it and the state SCP answered when it was delivered."""

    def __init__(self, app, seq: int):
        from stellar_core_tpu_torch.xdr import types as T
        self.app, self.seq, self.types = app, seq, T
        self.env = self.triple = self.primed = self.state = None
        om, scp = app.overlay_manager, app.herder.scp
        real_drain, real_receive = om._drain_scp_inbox, scp.receive_envelope

        def drain():
            if self.env is None:
                self._inject(om._scp_inbox)
            real_drain()
            if self.triple is not None and self.primed is None:
                self.primed = app.herder.driver._sig_verdicts.get(self.triple)

        def receive_envelope(env):
            state = real_receive(env)
            if env is self.env:
                self.state = state
            return state

        om._drain_scp_inbox, scp.receive_envelope = drain, receive_envelope

    def _inject(self, inbox) -> None:
        herder, own = self.app.herder, self.app.config.node_id()
        for env in list(inbox):
            st = env.statement
            if st.slotIndex == self.seq and st.nodeID.value != own and \
                    not herder.pending_envelopes.missing_for(env):
                self.env = self.types.SCPEnvelope.make(statement=st,
                                                       signature=bytes(64))
                self.triple = herder.driver.envelope_sig_triple(self.env)
                inbox.append(self.env)
                return


def run_network(crypto_backend: str, tally_backend: str, device=None,
                n_orgs=NET_ORGS, per_org=NET_PER_ORG,
                emit_line=None) -> dict:
    """The port's ``hierarchical_quorum(n_orgs, per_org)`` network (the JAX
    builder's thresholds and links) on ``crypto_backend`` /
    ``tally_backend`` with ``device``, started and settled, then: a ledger
    in which the root creates ``NET_ACCOUNTS`` accounts in one
    transaction, and ``NET_PAYMENT_LEDGERS`` ledgers of one payment per
    account (account i to i + 1, one signature each), submitted round-robin
    to the nodes through ``herder.recv_transaction``, flooded over the
    overlay and closed by ``close_ledger()``.  During slot
    ``NET_FORGE_SEQ`` the last node's inbox gets one forged envelope
    (``ForgedEnvelope``).  Checks: every ledger closes on every node with
    one header hash, every transaction succeeds on every node, the forged
    envelope is primed False and refused, no tally differs from the host
    oracle (``TallyMismatch``) or falls back, and on ``"cuda"`` every
    overlay batch of 2 or more well-formed triples is one launch on its
    ``SIG_BATCH_BUCKETS`` size and every close with transactions one
    launch.  ``emit_line`` gets one dict a ledger.  Returns the run's
    numbers, with its device tally calls (``tally_calls``) and the widest
    of them (``widest_tally``, as ``TallyProbe.widest``)."""
    from stellar_core_tpu_torch.herder.tx_queue import TransactionQueue
    from stellar_core_tpu_torch.scp.scp import EnvelopeState
    from stellar_core_tpu_torch.scp.tally import TallyEngine, TallyMismatch
    from stellar_core_tpu_torch.simulation import hierarchical_quorum
    from stellar_core_tpu_torch.utils.device import pad_signature_batch

    emit_line = emit_line or (lambda line: None)
    on_cuda = crypto_backend == "cuda"
    on_card = device is not None and torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    sim = hierarchical_quorum(n_orgs, per_org, device=device,
                              CRYPTO_BACKEND=crypto_backend,
                              SCP_TALLY_BACKEND=tally_backend)
    apps = list(sim.nodes.values())
    sim.start_all_nodes()
    settle(sim)
    forged = ForgedEnvelope(apps[-1], NET_FORGE_SEQ)
    root = Account.root(apps[0])
    accounts = [Account.named(apps[0], b"net-account-%d" % i)
                for i in range(NET_ACCOUNTS)]
    out = {"nodes": len(apps), "setup_seconds": time.perf_counter() - t0,
           "ledgers": []}
    pending = TransactionQueue.ADD_STATUS_PENDING

    def ledger(probe, tallies, kind, envs) -> None:
        n_batches, n_closes = len(probe.batches), len(probe.closes)
        calls0 = sum(tallies.calls.values())
        seconds0 = (probe.verify_seconds, probe.close_seconds,
                    tallies.device_seconds, tallies.oracle_seconds)
        t0 = time.perf_counter()
        got = [apps[i % len(apps)].herder.recv_transaction(env)
               for i, env in enumerate(envs)]
        if got != [pending] * len(envs):
            raise AssertionError(f"{kind}: admission statuses {got}")
        settle(sim)
        submit_s = time.perf_counter() - t0
        target = apps[0].ledger_manager.last_closed_seq() + 1
        t0 = time.perf_counter()
        if not sim.close_ledger(timeout=200):
            raise AssertionError(f"{kind}: ledger {target} did not close")
        if on_card:
            torch.cuda.synchronize()
        close_s = time.perf_counter() - t0
        chains = {nid: sim.header_chain(nid)[target] for nid in sim.nodes}
        if set(app.ledger_manager.last_closed_seq() for app in apps) != \
                {target} or len(set(chains.values())) != 1:
            raise AssertionError(f"{kind}: the nodes differ at ledger "
                                 f"{target}")
        results = {tuple(close_results(app)) for app in apps}
        if len(results) != 1 or [c for c, _ in next(iter(results))] != \
                ["txSUCCESS"] * len(envs):
            raise AssertionError(f"{kind}: results {results}")
        batches = probe.batches[n_batches:]
        closes = probe.closes[n_closes:]
        for n, well, launches, padded in batches:
            want = 1 if on_cuda and n >= 2 and well else 0
            if launches != want or padded != [pad_signature_batch(n)] * want:
                raise AssertionError(
                    f"{kind}: an overlay batch of {n} triples made "
                    f"{launches} launches on {padded} rows")
        if closes != [1 if on_cuda else 0] * len(apps):
            raise AssertionError(f"{kind}: close launches {closes}")
        header_hash, _ = next(iter(chains.values()))
        line = {"phase": "network", "backend": crypto_backend,
                "tally": tally_backend, "ledger": target, "kind": kind,
                "txs": len(envs), "header_hash": header_hash.hex(),
                "nodes_equal": len(apps),
                "overlay_batches": len(batches),
                "overlay_triples": sum(b[0] for b in batches),
                "overlay_launches": sum(b[2] for b in batches),
                "overlay_rows": spread([b[0] for b in batches if b[2]]),
                "overlay_padded": spread([r for b in batches for r in b[3]]),
                "host_batches": sum(1 for b in batches if b[0] < 2),
                "close_launches": sum(closes),
                "tally_calls": sum(tallies.calls.values()) - calls0,
                "submit_seconds": submit_s, "close_ms": close_s * 1e3}
        # host ms of close_ms spent in each seam, over all the nodes
        for key, now, then in zip(
                ("overlay_verify_ms", "ledger_close_ms", "tally_device_ms",
                 "tally_oracle_ms"),
                (probe.verify_seconds, probe.close_seconds,
                 tallies.device_seconds, tallies.oracle_seconds), seconds0):
            line[key] = (now - then) * 1e3
        out["ledgers"].append(line)
        emit_line(line)

    try:
        with NetworkProbe(forged) as probe, \
                TallyProbe(TallyEngine) as tallies:
            ledger(probe, tallies, "create", [root.tx(
                [root.op_create_account(a.account_id, 10**10)
                 for a in accounts])])
            for _ in range(NET_PAYMENT_LEDGERS):
                ledger(probe, tallies, "payments", [a.tx([a.op_payment(
                    accounts[(i + 1) % NET_ACCOUNTS].account_id, 1 + i)])
                    for i, a in enumerate(accounts)])
    except TallyMismatch as e:
        raise AssertionError(f"tensor tally != host oracle: {e}") from e
    if forged.env is None or forged.primed is not False or \
            forged.state != EnvelopeState.INVALID:
        raise AssertionError(
            f"the forged envelope was not refused: injected "
            f"{forged.env is not None}, primed {forged.primed}, state "
            f"{forged.state}")
    engines = [s.tally for app in apps for s in app.herder.scp.slots.values()
               if s.tally is not None]
    fallbacks = sum(e.host_fallbacks for e in engines)
    if fallbacks:
        raise AssertionError(f"{fallbacks} tallies fell back to the host")
    counters = {name: sum(app.metrics.counter(name).count for app in apps)
                for name in ("overlay.sigbatch.batches",
                             "overlay.sigbatch.envelopes")}
    if counters["overlay.sigbatch.batches"] < len(probe.batches):
        raise AssertionError(f"sigbatch counters {counters} for "
                             f"{len(probe.batches)} batches")
    out.update(batches=probe.batches, closes=probe.closes,
               kept_batch=probe.kept,
               launched_triples=list(probe.triples), counters=counters,
               forged={"seq": NET_FORGE_SEQ, "primed": forged.primed,
                       "state": EnvelopeState(forged.state).name},
               hashes=[line["header_hash"] for line in out["ledgers"]],
               tally_calls=sum(tallies.calls.values()),
               widest_tally=tallies.widest)
    return out


def network_phase(card_line: str, dev) -> tuple[int, int, int, tuple]:
    """The ``network`` phase: network A (``run_network`` on
    ``CRYPTO_BACKEND="cuda"``, ``both`` tallies, on ``dev``; the verify
    kernel's launches counted from 0) and network B (``"cpu"``, ``"host"``)
    on the same seeds and transactions, which must give the same header
    hash in every ledger; the kernel held against its plain version on the
    overlay batch that carried the forged envelope and on every distinct
    triple of A's launched overlay batches, and that batch replayed by CUDA
    events.  Prints its lines; returns A's (overlay, close) launches, its
    device tally calls and the widest of them.  Raises on any failed
    check, and when the phase runs past ``NET_MAX_SECONDS``."""
    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
    from stellar_core_tpu_torch.utils.device import (pad_signature_batch,
                                                     signature_columns)

    t_phase = time.perf_counter()
    emit({"phase": "network", "card": card_line,
          "validators": NET_ORGS * NET_PER_ORG, "orgs": NET_ORGS,
          "per_org": NET_PER_ORG, "accounts": NET_ACCOUNTS,
          "payment_ledgers": NET_PAYMENT_LEDGERS,
          "forge_seq": NET_FORGE_SEQ})
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    t0 = time.perf_counter()
    net_a = run_network("cuda", "both", dev, emit_line=emit)
    a_s = time.perf_counter() - t0
    launches = ed25519_cuda.launches
    batches = net_a["batches"]
    overlay = sum(b[2] for b in batches)
    close = sum(net_a["closes"])
    if overlay < 1 or overlay + close != launches:
        raise AssertionError(f"{launches} verify launches: {overlay} overlay "
                             f"+ {close} close")
    t0 = time.perf_counter()
    net_b = run_network("cpu", "host", emit_line=emit)
    b_s = time.perf_counter() - t0
    if net_a["hashes"] != net_b["hashes"] or \
            net_a["forged"] != net_b["forged"]:
        raise AssertionError(
            f"network A differs from the cpu-backend network B: "
            f"{net_a['hashes']} {net_a['forged']} vs {net_b['hashes']} "
            f"{net_b['forged']}")
    # the kernel against its plain version on the overlay batch that held
    # the forged envelope, at the path's shape, and on every distinct
    # triple that A's launched batches carried: these launches come after
    # the count was read
    batch = net_a["kept_batch"]
    distinct = [torch.as_tensor(c, device=dev)
                for c in signature_columns(net_a["launched_triples"])]
    false_rows = []
    for label, rows in (("the forged envelope's batch", batch),
                        ("the distinct triples", distinct)):
        got = ed25519_cuda.verify_batch(*rows)
        want = ed25519_kernel.verify_batch(*rows)
        if not torch.equal(got, want):
            raise AssertionError(
                f"the kernel differs from the plain version on {label} in "
                f"{int((got != want).sum())} of {got.shape[0]} rows")
        false_rows.append(int((~want).sum()))
    if false_rows[1] < 1:
        raise AssertionError("the forged triple is not among the distinct "
                             "triples of A's launched batches")
    kernel_ms = cuda_ms(lambda: ed25519_cuda.verify_batch(*batch))
    plain_ms = cuda_ms(lambda: ed25519_kernel.verify_batch(*batch), reps=1)
    ledgers = net_a["ledgers"]
    launched = [b[0] for b in batches if b[2]]
    seconds = time.perf_counter() - t_phase
    emit({"phase": "network", "validators": net_a["nodes"],
          "ledgers_closed": len(ledgers),
          "header_hashes": net_a["hashes"], "nodes_equal": net_a["nodes"],
          "equal_to_cpu_network": True,
          "overlay_batches": len(batches),
          "overlay_envelopes":
              net_a["counters"]["overlay.sigbatch.envelopes"],
          "overlay_triples": sum(b[0] for b in batches),
          "overlay_launches": overlay,
          "overlay_rows": spread(launched),
          "overlay_padded": spread([pad_signature_batch(n)
                                    for n in launched]),
          "host_batches": sum(1 for b in batches if b[0] < 2),
          "close_launches": close,
          "close_launches_per_ledger": [line["close_launches"]
                                        for line in ledgers],
          "tally_calls_per_ledger": [line["tally_calls"] for line in ledgers],
          "tally_mismatches": 0, "forged": net_a["forged"],
          "close_ms": [line["close_ms"] for line in ledgers],
          **{key: [line[key] for line in ledgers] for key in (
              "overlay_verify_ms", "ledger_close_ms", "tally_device_ms",
              "tally_oracle_ms")},
          "cpu_network_close_ms": [line["close_ms"]
                                   for line in net_b["ledgers"]],
          "kernel_equal_to_plain_on_batch": True,
          "batch_rows_false": false_rows[0],
          "kernel_equal_to_plain_on_distinct_triples": True,
          "distinct_triples": int(distinct[0].shape[0]),
          "distinct_triples_false": false_rows[1],
          "kernel_ms_replayed": kernel_ms, "plain_ms_replayed": plain_ms,
          "kernel_rows_replayed": int(batch[0].shape[0]),
          "setup_seconds": net_a["setup_seconds"], "network_a_seconds": a_s,
          "network_b_seconds": b_s, "seconds": seconds})
    if seconds > NET_MAX_SECONDS:
        raise AssertionError(f"the network phase took {seconds:.1f} s, "
                             f"over its {NET_MAX_SECONDS} s budget")
    return overlay, close, net_a["tally_calls"], net_a["widest_tally"]


# -- the headline bench, data-parallel admission, the node's command line ----

def bench_phase(card_line: str, dev) -> tuple[int, tuple]:
    """The ``bench`` phase: the port's headline bench
    (``stellar_core_tpu_torch.bench.run``) on ``dev`` with
    ``BENCH_SIGNATURES`` signatures and ``BENCH_CLOSES`` closes a shape (the
    bench's default 24, cut), the verify kernel's launches counted from 0.
    Prints the bench's lines, its last line as its own line; returns the
    launches and the config #2 batch (pk, sg, mg).  Raises on a false
    verdict, the kernel differing from its plain version, or a ledger hash
    that differs between the bench's ``cuda`` and ``cpu`` nodes (the bench
    raises on each), and on a line that does not say so."""
    import gc

    from stellar_core_tpu_torch import bench
    from stellar_core_tpu_torch.ops import ed25519_cuda

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    out = bench.run(dev, n_sigs=BENCH_SIGNATURES, n_closes=BENCH_CLOSES,
                    close_txs=BENCH_CLOSE_TXS, emit=emit)
    torch.cuda.synchronize()
    launches = ed25519_cuda.launches
    line = out["line"]
    emit(line)
    if (line["kernel"], line["kernel_equal_to_plain"],
            line["close_ledger_hashes_equal"]) != ("cuda", True, True) or \
            line["verdicts_true"] != line["n_padded"] or \
            line["n_signatures"] != BENCH_SIGNATURES:
        raise AssertionError(f"bench line: {line}")
    # the verify stage (a build call, 3 timed, 3 by CUDA events), the
    # close's seam once, and one launch a close of node A
    want = 7 + 1 + 3 * BENCH_CLOSES
    if launches != want:
        raise AssertionError(f"{launches} bench launches, {want} expected")
    emit({"phase": "bench", "card": card_line, "launches": launches,
          "signatures": BENCH_SIGNATURES, "closes_per_shape": BENCH_CLOSES,
          "close_txs": BENCH_CLOSE_TXS,
          "reduced": {"closes_per_shape": {"bench_default": 24,
                                           "before": 4,
                                           "here": BENCH_CLOSES}},
          "seconds": time.perf_counter() - t0})
    gc.collect()
    return launches, out["batch"]


def parallel_phase(card_line: str, batch) -> int:
    """The ``parallel`` phase: ``bench_sharded`` over every visible card on
    the bench's config #2 batch (from a workload file, as the JAX bench
    reads one; the launches counted from 0), then ``dryrun_multichip(8)``
    over 8 CPU chunks, which raises unless each sharded result equals the
    unsharded step.  Prints its line; returns the launches."""
    import os
    import tempfile

    from stellar_core_tpu_torch import entry
    from stellar_core_tpu_torch.models import admission as A
    from stellar_core_tpu_torch.ops import ed25519_cuda

    t0 = time.perf_counter()
    pk, sg, mg = batch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workload.npz")
        np.savez(path, pk=pk, sg=sg, mg=mg)
        torch.cuda.synchronize()
        ed25519_cuda.reset_launches()
        res = A.bench_sharded(torch.cuda.device_count(),
                              n_sigs=pk.shape[0], workload_npz=path)
        torch.cuda.synchronize()
        launches = ed25519_cuda.launches
    if launches != 2 * res["n_devices"]:
        raise AssertionError(f"{launches} launches for {res['n_devices']} "
                             "devices (a first call and one rep each)")
    t1 = time.perf_counter()
    dry = entry.dryrun_multichip(8)
    emit({"phase": "parallel", "card": card_line, "bench_sharded": res,
          "launches": launches,
          "dryrun_multichip": {"chunks": 8, "device": "cpu",
                               "signatures": int(dry["sig_ok"].shape[0]),
                               "validators": int(
                                   dry["tally_accept"].shape[0]),
                               "equal_to_unsharded": True,
                               "seconds": time.perf_counter() - t1},
          "seconds": time.perf_counter() - t0})
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(port: int, path: str, timeout: float = 5.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def cli_tomls(tmp, seeds, backend: str) -> tuple[list, list, list]:
    """Two node TOMLs of a 2-of-2 network over localhost, as
    ``tests/test_tcp_node.py`` writes them, on ``backend`` (tallies
    ``tensor`` on ``cuda``, ``host`` on ``cpu``), traces under ``tmp``.
    Returns the paths and the peer and HTTP ports."""
    from pathlib import Path

    from stellar_core_tpu_torch.crypto import SecretKey
    from stellar_core_tpu_torch.crypto.strkey import (
        encode_ed25519_public_key, encode_ed25519_seed)

    ids = [encode_ed25519_public_key(SecretKey(s).public_key().raw)
           for s in seeds]
    peer_ports = [free_port(), free_port()]
    http_ports = [free_port(), free_port()]
    tally = "tensor" if backend == "cuda" else "host"
    paths = []
    for i, seed in enumerate(seeds):
        path = Path(tmp) / f"node{i}.toml"
        peers = f'"127.0.0.1:{peer_ports[1 - i]}"' if i == 1 else ""
        path.write_text(f"""
network_passphrase = "{CLI_PASSPHRASE}"
node_seed = "{encode_ed25519_seed(seed)}"
peer_port = {peer_ports[i]}
http_port = {http_ports[i]}
known_peers = [{peers}]
manual_close = false
artificially_accelerate_time_for_testing = true
exp_ledger_timespan_seconds = 1.0
invariant_checks = [".*"]
trace_dir = "{Path(tmp) / 'traces'}"
crypto_backend = "{backend}"
scp_tally_backend = "{tally}"

[quorum_set]
threshold = 2
validators = [{", ".join(f'"{x}"' for x in ids)}]
""")
        paths.append(path)
    return paths, peer_ports, http_ports


def run_cli(backend: str) -> dict:
    """Two ``python -m stellar_core_tpu_torch --conf <toml> run`` processes
    on ``backend`` (2-of-2 over localhost TCP), driven over their admin
    HTTP: once both close ledgers, ``tx?blob=`` (the root creates an
    account), ``generateload?mode=create`` then ``mode=pay`` on node 0,
    ``quorum?intersection=true``; then both must close ``CLI_LEDGERS``
    more ledgers with nothing pending, and agree on the header hash at a
    common height.  Every wait ends by ``CLI_MAX_SECONDS``; the children are
    stopped (SIGINT, then killed) on every way out.  Returns what it saw,
    with each node's ``/metrics`` counters."""
    import base64
    import os
    import signal
    import tempfile
    import urllib.parse
    from pathlib import Path
    from types import SimpleNamespace

    from stellar_core_tpu_torch.crypto import SecretKey, sha256
    from stellar_core_tpu_torch.xdr import types as T

    t_start = time.monotonic()

    def wait(what, poll):
        """Poll ``poll()`` until it gives a value, within the deadline."""
        while True:
            if time.monotonic() - t_start > CLI_MAX_SECONDS:
                raise AssertionError(f"the CLI nodes ran past "
                                     f"{CLI_MAX_SECONDS} s waiting for {what}")
            try:
                got = poll()
            except OSError:   # an endpoint not up yet, a refused connect
                got = None
            if got:
                return got
            time.sleep(0.25)

    repo = Path(__file__).resolve().parent
    seeds = [sha256(b"tcp-node-%d" % i) for i in range(2)]
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tomls, _, ports = cli_tomls(tmp, seeds, backend)
        env = dict(os.environ, PYTHONPATH=str(repo))
        procs, logs = [], []
        try:
            for i, toml in enumerate(tomls):
                # log to files, never a pipe: an unread pipe fills and
                # blocks the node mid-write
                log = open(Path(tmp) / f"node{i}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "stellar_core_tpu_torch",
                     "--conf", str(toml), "run"], cwd=tmp, env=env,
                    stdout=log, stderr=subprocess.STDOUT))

            def infos():
                for p in procs:
                    if p.poll() is not None:
                        raise AssertionError(
                            f"a CLI node exited with {p.returncode}: "
                            + (Path(tmp) / "node0.log").read_text()[-2000:]
                            + (Path(tmp) / "node1.log").read_text()[-2000:])
                return [http_json(p, "info")["info"] for p in ports]

            def height(i) -> int:
                return i["ledger"].get("num", 0)

            wait("both nodes closing", lambda: min(
                height(i) for i in infos()) >= 3)
            out["boot_seconds"] = time.monotonic() - t_start

            # the root (its seed is the network id) creates an account,
            # through tx?blob
            root = Account(SimpleNamespace(config=SimpleNamespace(
                network_id=lambda: sha256(CLI_PASSPHRASE.encode()))),
                SecretKey(sha256(CLI_PASSPHRASE.encode())))
            env_tx = root.tx([root.op_create_account(
                SecretKey(sha256(b"cli-dest")).public_key().raw, 10**9)],
                seq=1)
            blob = base64.b64encode(
                T.TransactionEnvelope.encode(env_tx)).decode()
            res = http_json(ports[0], "tx?blob=" + urllib.parse.quote(blob))
            if res.get("status") != "PENDING":
                raise AssertionError(f"tx?blob: {res}")

            def settled(after: int) -> bool:
                got = infos()
                return all(i["pending_txs"] == 0 and height(i) > after
                           for i in got)

            start = max(height(i) for i in infos())
            wait("the tx applied", lambda: settled(start))
            res = http_json(ports[0], "generateload?mode=create&accounts="
                            f"{CLI_ACCOUNTS}")
            if res.get("status_counts") != {"0": CLI_ACCOUNTS // 100}:
                raise AssertionError(f"generateload create: {res}")
            start = max(height(i) for i in infos())
            wait("the accounts created", lambda: settled(start))
            res = http_json(ports[0], f"generateload?mode=pay&txs="
                            f"{CLI_ACCOUNTS}")
            if res.get("status_counts") != {"0": CLI_ACCOUNTS}:
                raise AssertionError(f"generateload pay: {res}")
            out["quorum"] = http_json(ports[0], "quorum?intersection=true",
                                      timeout=60.0)
            if out["quorum"].get("intersection") is not True:
                raise AssertionError(f"quorum: {out['quorum']}")
            start = max(height(i) for i in infos())
            wait("the payments applied", lambda: settled(start))
            wait(f"{CLI_LEDGERS} more ledgers", lambda: min(
                height(i) for i in infos()) >= start + CLI_LEDGERS)

            def common():
                got = infos()
                if height(got[0]) == height(got[1]):
                    return got
                return None
            got = wait("a common height", common)
            hashes = {i["ledger"]["hash"] for i in got}
            if len(hashes) != 1:
                raise AssertionError(f"header hashes differ at ledger "
                                     f"{height(got[0])}: {hashes}")
            out.update(ledger=height(got[0]), hash=hashes.pop(),
                       crypto_backend=[i["crypto_backend"] for i in got])
            # the fleet scraper over both nodes' admin endpoints
            from stellar_core_tpu_torch.tools import fleet_scrape

            scraped = fleet_scrape.run(
                [f"127.0.0.1:{p}" for p in ports], CLI_SCRAPE_ROUNDS, 0.5,
                str(Path(tmp) / "fleet.jsonl"))
            out["fleet"] = scraped["fleet"]
            if out["fleet"]["n_reachable"] != 2 or \
                    out["fleet"]["ledger_spread"] > 1:
                raise AssertionError(f"fleet_scrape: {out['fleet']}")
            out["metrics"] = []
            for p in ports:
                snap = http_json(p, "metrics")["metrics"]
                got = {name: snap.get(name, {}).get("count", 0)
                       for name in CLI_COUNTERS}
                if CLI_LAUNCHES in snap:
                    got[CLI_LAUNCHES] = int(snap[CLI_LAUNCHES]["value"])
                out["metrics"].append(got)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGINT)
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    out["seconds"] = time.monotonic() - t_start
    return out


def cli_phase(card_line: str) -> int:
    """The ``cli`` phase: ``run_cli`` on ``CRYPTO_BACKEND="cuda"`` (each
    child builds the verify kernel from the checkout on its first batch).
    Each node must have batched its overlay envelopes and launched the
    kernel: its ``/metrics`` gauge ``crypto.verify.kernel-launches`` reads
    the wrapper's own launch counter in that process.  Prints its line;
    returns the two nodes' launches."""
    out = run_cli("cuda")
    per_node = [m.get(CLI_LAUNCHES, 0) for m in out["metrics"]]
    if out["crypto_backend"] != ["cuda", "cuda"] or min(per_node) < 1 or any(
            m["overlay.sigbatch.batches"] < 1 for m in out["metrics"]):
        raise AssertionError(f"the CLI nodes' batches: {out['metrics']}")
    emit({"phase": "cli", "card": card_line, **out,
          "launches_per_node": per_node})
    return sum(per_node)


# -- chaos and fuzz: the network's fault harnesses on the card --------------

def run_chaos(scenario: str, device, forge: bool, **node) -> dict:
    """``chaos_bench``'s core-4 tier (``core(4)``, pipelined close, free
    running) through ``scenario`` at ``CHAOS_SEED`` with the node keywords
    ``node`` on ``device``, under a ``NetworkProbe`` and a ``TallyProbe``;
    with ``forge``, every node's inbox gets one forged envelope during slot
    ``CHAOS_FORGE_SEQ`` (``ForgedEnvelope``), which every node must prime
    False and refuse.  Raises on a failed oracle, a tally that differs from
    the host oracle (``TallyMismatch``) or a forged envelope that was not
    refused.  Returns the report with the probes' counts."""
    import tempfile

    from stellar_core_tpu_torch.scp.scp import EnvelopeState
    from stellar_core_tpu_torch.scp.tally import TallyEngine, TallyMismatch
    from stellar_core_tpu_torch.simulation.chaos import run_standard_scenario
    from stellar_core_tpu_torch.tools.chaos_bench import TIERS

    factory, n_nodes, duration = TIERS["core4"]
    forged: list = []

    def make_sim(d):
        sim = factory(d, device=device, **node)
        if forge:
            forged.extend(ForgedEnvelope(app, CHAOS_FORGE_SEQ)
                          for app in sim.nodes.values())
        return sim

    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d, NetworkProbe(None) as probe, \
                TallyProbe(TallyEngine) as tallies:
            rep = run_standard_scenario(
                lambda: make_sim(d), scenario, seed=CHAOS_SEED,
                n_nodes=n_nodes, duration=duration, forensics_dir=d)
    except TallyMismatch as e:
        raise AssertionError(f"{scenario}: tensor tally != host oracle: "
                             f"{e}") from e
    refused = [f.env is not None and f.primed is False and
               f.state == EnvelopeState.INVALID for f in forged]
    if not all(refused):
        raise AssertionError(f"{scenario}: a forged envelope was not "
                             f"injected and refused: {refused}")
    if rep["fork_check"] != "pass":
        raise AssertionError(f"{scenario}: fork check {rep['fork_check']}")
    batches = probe.batches
    return {"scenario": scenario, "fingerprint": rep["fingerprint"],
            "ledgers_closed": rep["ledgers_closed"],
            "time_to_heal_s": rep["time_to_heal_s"],
            "counters": rep["counters"],
            "overlay_batches": len(batches),
            "overlay_launches": sum(b[2] for b in batches),
            "overlay_padded": sorted({r for b in batches for r in b[3]}),
            "close_launches": sum(probe.closes),
            "false_verdicts": probe.false_verdicts,
            "forged_refused": len(forged),
            "tally_calls": sum(tallies.calls.values()),
            "triples": list(probe.triples),
            "seconds": time.perf_counter() - t0}


def chaos_phase(card_line: str, dev) -> int:
    """The ``chaos`` phase: each of ``CHAOS_SCENARIOS`` runs twice on the
    card (``CRYPTO_BACKEND="cuda"``, ``"both"`` tallies on ``dev``; the
    first with a forged envelope in every node's inbox) and once on a
    ``"cpu"`` / ``"host"`` twin; the three fingerprints must equal the JAX
    package's for the same seed (``CHAOS_FINGERPRINTS``, held by
    ``tests/test_torch_chaos.py``), every forged envelope must be refused,
    and every launched batch's verdicts must equal the plain version's.
    Prints one line a scenario; returns the card runs' launches."""
    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
    from stellar_core_tpu_torch.utils.device import signature_columns

    t_phase = time.perf_counter()
    emit({"phase": "chaos", "card": card_line, "tier": "core4",
          "scenarios": list(CHAOS_SCENARIOS), "seed": CHAOS_SEED,
          "forge_seq": CHAOS_FORGE_SEQ})
    card = {"CRYPTO_BACKEND": "cuda", "SCP_TALLY_BACKEND": "both"}
    total = 0
    for scenario in CHAOS_SCENARIOS:
        torch.cuda.synchronize()
        ed25519_cuda.reset_launches()
        runs = [run_chaos(scenario, dev, True, **card),
                run_chaos(scenario, dev, False, **card)]
        torch.cuda.synchronize()
        launches = ed25519_cuda.launches
        twin = run_chaos(scenario, "cpu", False, CRYPTO_BACKEND="cpu",
                         SCP_TALLY_BACKEND="host")
        fps = [r["fingerprint"] for r in runs + [twin]]
        if set(fps) != {CHAOS_FINGERPRINTS[scenario]}:
            raise AssertionError(f"{scenario}: fingerprints {fps}, the JAX "
                                 f"package's {CHAOS_FINGERPRINTS[scenario]}")
        counted = sum(r["overlay_launches"] + r["close_launches"]
                      for r in runs)
        if launches < 1 or launches != counted or twin["overlay_launches"]:
            raise AssertionError(f"{scenario}: {launches} launches, "
                                 f"{counted} counted by the probe")
        # every distinct triple the card's batches carried, kernel against
        # plain: these launches come after the count was read
        rows = [torch.as_tensor(c, device=dev) for c in signature_columns(
            list(dict.fromkeys(runs[0]["triples"] + runs[1]["triples"])))]
        got = ed25519_cuda.verify_batch(*rows)
        want = ed25519_kernel.verify_batch(*rows)
        if not torch.equal(got, want) or int((~want).sum()) < 1:
            raise AssertionError(f"{scenario}: the kernel differs from the "
                                 "plain version, or no forged triple")
        total += launches
        emit({"phase": "chaos", "scenario": scenario,
              "fingerprint": fps[0], "equal_to_jax_and_cpu_twin": True,
              "launches": launches,
              **{key: [r[key] for r in runs] for key in (
                  "ledgers_closed", "time_to_heal_s", "overlay_batches",
                  "overlay_launches", "overlay_padded", "close_launches",
                  "false_verdicts", "forged_refused", "tally_calls",
                  "seconds")},
              "counters": runs[0]["counters"], "tally_mismatches": 0,
              "kernel_equal_to_plain_on_distinct_triples": True,
              "distinct_triples": int(rows[0].shape[0]),
              "distinct_triples_false": int((~want).sum()),
              "cpu_twin_seconds": twin["seconds"]})
    emit({"phase": "chaos", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


def fuzz_phase(card_line: str, dev) -> int:
    """The ``fuzz`` phase: ``verify_repro`` of every committed
    ``traces/FUZZ_REPRO_*.json`` with its networks on the card
    (``run_schedule`` with ``device=dev``, ``CRYPTO_BACKEND="cuda"``,
    ``"both"`` tallies); each must reproduce its committed failure class
    and fingerprint.  Prints one line a repro; returns the launches."""
    from pathlib import Path

    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.scp.tally import TallyEngine
    from stellar_core_tpu_torch.simulation.fuzz.executor import run_schedule
    from stellar_core_tpu_torch.simulation.fuzz.minimize import verify_repro
    from stellar_core_tpu_torch.simulation.fuzz.schedule import load_schedule

    repros = sorted((Path(__file__).resolve().parent / "traces").glob(
        "FUZZ_REPRO_*.json"))
    if len(repros) < 2:
        raise AssertionError(f"repro artifacts: {repros}")
    run = functools.partial(run_schedule, device=dev, CRYPTO_BACKEND="cuda",
                            SCP_TALLY_BACKEND="both")
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    t_phase = time.perf_counter()
    for path in repros:
        doc = load_schedule(str(path))
        launches0 = ed25519_cuda.launches
        t0 = time.perf_counter()
        with NetworkProbe(None) as probe, TallyProbe(TallyEngine) as tallies:
            verdict = verify_repro(doc, run=run)
        torch.cuda.synchronize()
        launches = ed25519_cuda.launches - launches0
        if not verdict["reproduced"] or launches < 1:
            raise AssertionError(f"{path.name} on the card: {verdict}, "
                                 f"{launches} launches")
        emit({"phase": "fuzz", "card": card_line, "repro": path.name,
              "reproduced": True, "got": verdict["got"],
              "error": verdict["error"], "launches": launches,
              "overlay_batches": len(probe.batches),
              "false_verdicts": probe.false_verdicts,
              "tally_calls": sum(tallies.calls.values()),
              "seconds": time.perf_counter() - t0})
    torch.cuda.synchronize()
    launches = ed25519_cuda.launches
    emit({"phase": "fuzz", "repros": len(repros), "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def tools_phase(card_line: str) -> int:
    """The ``tools`` phase: four of the port's benchmark tools in-process,
    their ``cuda`` arms on the card, each checked against a ``cpu`` node or
    the committed artifact; returns the launches of the card arms (the
    ``cpu`` comparisons launch nothing).  Prints one line a tool."""
    import hashlib
    from pathlib import Path

    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.tools import parallel_apply_bench as PAB
    from stellar_core_tpu_torch.tools import pipeline_bench, soak_bench
    from stellar_core_tpu_torch.tools import scp_forensics_bench as SFB

    forensics = Path(__file__).resolve().parent / \
        "FORENSICS_induced_fork_seed14.json"
    want_dump = hashlib.sha256(forensics.read_bytes()).hexdigest()
    t_phase = time.perf_counter()
    emit({"phase": "tools", "card": card_line, "tools": [
        "pipeline_bench.parity_pass", "parallel_apply_bench.fingerprint",
        "soak_bench.soak_run", "scp_forensics_bench.fork_probe"]})
    t0 = time.perf_counter()
    host = pipeline_bench.parity_pass("cpu", TOOLS_WORKERS)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    total = 0

    def step(name, fn):
        nonlocal total
        launches0 = ed25519_cuda.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = ed25519_cuda.launches - launches0
        if launches < 1:
            raise AssertionError(f"tools/{name} launched the kernel no time")
        total += launches
        return out, launches, time.perf_counter() - t0

    row, launches, secs = step("pipeline_bench", lambda: (
        pipeline_bench.parity_pass("cuda", TOOLS_WORKERS)))
    if not row["hashes_identical"] or \
            row["last_ledger_hash"] != host["last_ledger_hash"]:
        raise AssertionError(f"pipeline parity on the card: {row}, cpu "
                             f"{host}")
    emit({"phase": "tools", "tool": "pipeline_bench", "closes": row["closes"],
          "hashes_identical": True, "equal_to_cpu_node": True,
          "launches": launches, "seconds": secs, "cpu_seconds": host_s})

    t0 = time.perf_counter()
    want, _ = PAB.fingerprint_workload("pay", 2, True, TOOLS_APPLY_CLOSES,
                                       TOOLS_APPLY_TXS, backend="cpu")
    cpu_s = time.perf_counter() - t0
    (got, stats), launches, secs = step("parallel_apply_bench", lambda: (
        PAB.fingerprint_workload("pay", 2, True, TOOLS_APPLY_CLOSES,
                                 TOOLS_APPLY_TXS, backend="cuda")))
    if got != want:
        raise AssertionError(f"apply fingerprints differ: {got} vs {want}")
    emit({"phase": "tools", "tool": "parallel_apply_bench",
          "shape": "pay", "workers": 2, "closes": TOOLS_APPLY_CLOSES,
          "close_txs": TOOLS_APPLY_TXS, "equal_to_cpu_node": True,
          "native_hits": stats["native_hits"], "aborts": stats["aborts"],
          "launches": launches, "seconds": secs, "cpu_seconds": cpu_s})

    row, launches, secs = step("soak_bench", lambda: soak_bench.soak_run(
        "cuda", TOOLS_SOAK_RATE, TOOLS_SOAK_SECONDS, TOOLS_SOAK_ACCOUNTS,
        1.0))
    sustained = row["sustained"]
    counts = {str(k): v for k, v in sustained["admit_status_counts"].items()}
    if counts != {"0": sustained["submitted"]} \
            or sustained["applied_txs"] + sustained["queue_left"] != \
            sustained["submitted"] or not sustained["submitted"]:
        raise AssertionError(f"soak on the card: {sustained}")
    emit({"phase": "tools", "tool": "soak_bench", "rate_tx_s":
          TOOLS_SOAK_RATE, "duration_s": TOOLS_SOAK_SECONDS,
          "sustained": sustained, "close_ms": row["close_ms"],
          "verify_phase_ms": row["verify_phase_ms"], "slo": row["slo"],
          "measured_launches": row["measured_kernel_launches"],
          "launches": launches, "seconds": secs})

    row, launches, secs = step("scp_forensics_bench", lambda: SFB.fork_probe(
        "cuda", 14, 40.0))
    if not (row["attributed_to_byzantine"] and row["rerun_dump_identical"]
            and row["dump_sha256"] == want_dump):
        raise AssertionError(f"fork probe on the card: {row}")
    emit({"phase": "tools", "tool": "scp_forensics_bench",
          "dump_sha256": row["dump_sha256"], "equal_to_committed_dump": True,
          "first_divergence": row["first_divergence"],
          "launches": launches, "seconds": secs,
          "run_seconds": row["seconds"]})
    emit({"phase": "tools", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


def netobs_phase(card_line: str) -> int:
    """The ``netobs`` phase: ``chaos_bench.run_netobs`` on the core-4 tier
    with a ``cuda`` and a ``cpu`` arm in turns, tracing on and off (it
    prints each arm's row and asserts the five gates on both arms and the
    arms' equal digests); the ``cuda`` arm's observatory summary rendered by
    ``trace_view.render_propagation``.  Prints one line; returns the
    ``cuda`` arm's launches."""
    from stellar_core_tpu_torch.ops import ed25519_cuda
    from stellar_core_tpu_torch.tools import LAUNCHES, trace_view
    from stellar_core_tpu_torch.tools import chaos_bench

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    doc = chaos_bench.run_netobs([NETOBS_TIER], NETOBS_SEED, ["cuda", "cpu"])
    torch.cuda.synchronize()
    launches = ed25519_cuda.launches
    res = doc["tiers"][NETOBS_TIER]
    arms = [res[b][mode]["arm"] for b in ("cuda", "cpu")
            for mode in ("on", "off")]
    counted = sum(a[LAUNCHES] for a in arms if a["backend"] == "cuda")
    if launches < 1 or launches != counted or any(
            a[LAUNCHES] for a in arms if a["backend"] == "cpu"):
        raise AssertionError(f"netobs: {launches} launches, arms "
                             f"{[a[LAUNCHES] for a in arms]}")
    text = trace_view.render_propagation(res["cuda"]["on"]["observatory"])
    if not text.startswith("4 nodes,") or "time_to_90pct" not in text:
        raise AssertionError(f"render_propagation: {text[:400]}")
    emit({"phase": "netobs", "card": card_line, "tier": NETOBS_TIER,
          "seed": NETOBS_SEED,
          "arms": [{k: a[k] for k in (
              "backend", "trace_enabled", "buckets_s", "events",
              "wall_per_virtual_s", "attributed_pct", "close_p50_wall_s",
              "overlay_batches", "overlay_triples",
              "overlay_launched_batches", "overlay_padded_rows",
              "overlay_verify_s", "tally_calls", "tally_s", LAUNCHES,
              "bench_wall_s")} for a in arms],
          "gates": {b: res[b]["gates"] for b in ("cuda", "cpu")},
          "digests": res["cuda"]["on"]["digests"], "digests_equal": True,
          "propagation_render_lines": text.count("\n") + 1,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def special_scalar_cases(ref, rng):
    """(A encoding, s, h) rows: every special scalar as s, as h and as
    both, beside seeded scalars mod L and seeded keys."""
    rows = []
    for k in SPECIAL_SCALARS.values():
        a = ref.public_from_seed(rng.bytes(32))
        other = int.from_bytes(rng.bytes(32), "little") % L
        rows += [(a, k, other), (a, other, k), (a, k, k)]
    return rows


def check_double_scalar(ref, ed25519_cuda, rng, dev) -> int:
    """The kernel's [s]B + [h](-A) against the spec on the special
    scalars; returns the number of rows."""
    rows = special_scalar_cases(ref, rng)
    cols = [np.stack([np.frombuffer(v if isinstance(v, bytes) else
                                    v.to_bytes(32, "little"), np.uint8)
                      for v in col]) for col in zip(*rows)]
    got = ed25519_cuda.double_scalar(
        *(torch.as_tensor(c, device=dev) for c in cols)).cpu().numpy()
    for i, (a, s, h) in enumerate(rows):
        neg_a = ref.point_neg(ref.decode_point(a))
        want = ref.encode_point(ref.double_scalar_mult(s, h, neg_a))
        if got[i].tobytes() != want:
            raise AssertionError(f"double_scalar != spec at s={s}, h={h}")
    return len(rows)


@functools.cache
def decompress_work(ref, a: bytes) -> tuple[int, bool]:
    """Field multiplications of the verify kernel's decompression of A
    (18, and one more for the sqrt(-1) flip; its squarings are always 255),
    and whether A decodes."""
    p, y = ref.P, int.from_bytes(a, "little") & (2**255 - 1)
    u, v = (y * y - 1) % p, (ref.D * y * y + 1) % p
    x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
    flip = (v * x * x + u) % p == 0
    return 18 + flip, ref.decode_point(a) is not None


def zero_digits(k: int) -> int:
    """Digits of 0 among the 64 signed radix-16 digits of k < 2^254 (the
    nibbles of k + 0x88..8 that are 8)."""
    return (k + int("8" * 64, 16)).to_bytes(32, "little").hex().count("8")


def verify_work(ref, a: bytes, sig: bytes, msg: bytes) -> tuple[int, int]:
    """(squarings, multiplications) of the field that the verify kernel
    (csrc/ed25519_verify.cu) does for one row.  A row that the byte checks
    refuse takes none, one whose A is off the curve the decompression
    alone.  Any other takes the decompression, the [1..8](-A) table (65
    M), 64 windows of 4 doublings (16 S + 13 M) with an add of 8 M for
    each nonzero digit of h and one of 6 M for each nonzero digit of s,
    and the encoding (254 S + 13 M)."""
    r, s = sig[:32], int.from_bytes(sig[32:], "little")
    mask = 2**255 - 1
    if (s >= ref.L or int.from_bytes(a, "little") & mask >= ref.P
            or int.from_bytes(r, "little") & mask >= ref.P
            or ref.has_small_order(a) or ref.has_small_order(r)):
        return 0, 0
    mul, decodes = decompress_work(ref, a)
    if not decodes:
        return 255, mul
    h = ref.hram(r, a, msg)
    mul += (65 + 64 * 13 + 8 * (64 - zero_digits(h))
            + 6 * (64 - zero_digits(s)) + 13)
    return 255 + 64 * 16 + 254, mul


def bound_ms_verify(ref, pk, sg, mg) -> tuple[float, str, int]:
    """Least time the H100 could take to verify these rows: the larger of
    the bytes (each input read once, one byte out a row) over 3.35 TB/s
    and the 32x32->64-bit products over 16.7 T/s, the int32 multiply-add
    rate (half the 67 TFLOP/s fp32 FMA rate: 64 vs 128 lanes per SM per
    clock).  Products: 36 a squaring and 64 a multiplication, for the work
    that these rows need (``verify_work``); SHA-512, carries and the
    prologue are not counted, so this stays a lower bound.  Returns the
    ms, what bounds it, and the products."""
    products = 0
    for a, s, m in zip(pk, sg, mg):
        sq, mul = verify_work(ref, a.tobytes(), s.tobytes(), m.tobytes())
        products += 36 * sq + 64 * mul
    ops_ms = products / 16.7e12 * 1e3
    bytes_ms = len(pk) * (32 + 64 + 32 + 1) / 3.35e12 * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", products)


def bound_ms_ref10_count(n: int) -> float:
    """The bound as first counted, for the radix-2^25.5 reference
    algorithm: 3,868 field multiplications of 100 products each per row,
    over the same 16.7 T/s.  Printed beside ``bound_ms_verify`` so that
    shares of it compare with the first kernel's; it counts more than
    twice the work the kernel needs, so it is not the bound."""
    return n * 3868 * 100 / 16.7e12 * 1e3


class TallyProbe:
    """While active, counts and times the live tally calls of every
    ``TallyEngine`` by wrapping the engine class's device and host-oracle
    methods: calls by kind, seconds in the device part (the copy of the
    vote rows, the ops and the verdict's readback) and in the host oracle
    (host clock), and the latest device call with the most voters, as
    (voters, kind, fn, args) for a replay."""

    _WRAPPED = (("device_accept", "accept"), ("device_ratify", "ratify"),
                ("_host_accept", None), ("_host_ratify", None))

    def __init__(self, engine_cls):
        self.cls = engine_cls
        self.calls = {"accept": 0, "ratify": 0}
        self.device_seconds = 0.0
        self.oracle_seconds = 0.0
        self.widest = None
        self._saved: dict = {}

    def _wrap(self, real, kind):
        def wrapped(engine, *args):
            t0 = time.perf_counter()
            out = real(engine, *args)
            dt = time.perf_counter() - t0
            if kind is None:
                self.oracle_seconds += dt
                return out
            self.device_seconds += dt
            self.calls[kind] += 1
            voters = int(args[2][-1].sum())   # the vote row is the last row
            if self.widest is None or voters >= self.widest[0]:
                self.widest = (voters, kind, functools.partial(real, engine),
                               args)
            return out
        return wrapped

    def __enter__(self):
        for name, kind in self._WRAPPED:
            self._saved[name] = getattr(self.cls, name)
            setattr(self.cls, name, self._wrap(self._saved[name], kind))
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(self.cls, name, real)
        self._saved.clear()


def replay_counts(fn, quorum_ops) -> dict:
    """What one call of ``fn`` (a recorded live tally call) costs the host:
    the torch contraction trips it runs (``quorum_ops._contract_trip``
    counted; none where the call is one launch of the tally kernel, which
    ``tally_kernel_launches`` counts), and from torch.profiler the CUDA
    runtime calls by name (``cudaLaunchKernel``, copies,
    synchronizations) and the device-side kernels and copies.  Profiler
    counts are ``None`` where it saw no CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from stellar_core_tpu_torch.ops import quorum_cuda

    fn()
    torch.cuda.synchronize()
    launches0 = quorum_cuda.launches
    trips = []
    real = quorum_ops._contract_trip

    def counted(qsets, m):
        trips.append(1)
        return real(qsets, m)

    quorum_ops._contract_trip = counted
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
    finally:
        quorum_ops._contract_trip = real
    torch.cuda.synchronize()
    events = prof.events()
    runtime = collections.Counter(e.name for e in events
                                  if e.name.startswith("cuda"))
    device = [e.name for e in events if e.device_type == DeviceType.CUDA]
    copies = sum(1 for n in device if n.startswith(("Memcpy", "Memset")))
    return {"trips": len(trips),
            "tally_kernel_launches": quorum_cuda.launches - launches0,
            "runtime_calls": dict(runtime) or None,
            "device_kernels": len(device) - copies if device else None,
            "device_copies": copies if device else None}


class LaunchCount:
    """A kernel wrapper's ``launches`` counter read path by path:
    ``take(path)`` records the launches since the previous ``take`` (or
    since construction) under ``path`` and returns them."""

    def __init__(self, wrapper):
        self.wrapper, self.last, self.by_path = wrapper, wrapper.launches, {}

    def take(self, path: str) -> int:
        now = self.wrapper.launches
        self.by_path[path] = now - self.last
        self.last = now
        return self.by_path[path]


def plain_card_tally(quorum_ops, kind, local_qs, qsets, rows) -> bool:
    """The tally kernel's plain version on the card: the tally engine's
    torch ops (``ops/quorum.py``, as ``TallyEngine`` runs them on a CPU
    device) on the same card tensors."""
    dev_rows = torch.from_numpy(rows).to(qsets.top_mem.device)
    ratified = quorum_ops.federated_ratify(local_qs, qsets, dev_rows[-1:])[0]
    if kind == "accept":
        return bool(quorum_ops.is_v_blocking(local_qs, dev_rows[0:1])[0]
                    | ratified)
    return bool(ratified)


def tally_kernel_times(widest: dict, quorum_ops) -> dict:
    """The tally kernel against its plain version on recorded live calls
    (label -> ``TallyProbe.widest``): on each, the kernel's verdict
    (``ops/quorum_cuda.py``) = the torch ops' on the same card tensors, as
    accept where the call has two rows and as ratify of its vote row.
    Per call and kind, by CUDA events over ``LIVE_REPS`` back-to-back
    calls: ``ms`` through the kernel's wrapper (copy in, launch, copy out,
    synchronisation), ``plain_ms`` through the torch ops; ``kernel_ms``,
    the kernel's device time by torch.profiler; and ``bound_ms``, the
    floor of one call: a copy of the same row bytes in, one empty launch,
    a one-byte copy out and a synchronisation, timed here, plus the bytes
    the kernel reads (qsets and rows) at the HBM peak of 3.35 TB/s.
    Raises where a verdict differs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stellar_core_tpu_torch.ops import quorum_cuda

    out = {}
    for label, (voters, live_kind, _, args) in widest.items():
        local_qs, qsets, rows = args
        kinds = ("accept", "ratify") if rows.shape[0] == 2 else ("ratify",)
        for kind in kinds:
            krows = rows if kind == "accept" else rows[-1:]
            kernel = functools.partial(
                quorum_cuda.tally_accept if kind == "accept" else
                quorum_cuda.tally_ratify, local_qs, qsets, krows)
            plain = functools.partial(plain_card_tally, quorum_ops, kind,
                                      local_qs, qsets, krows)
            got, want = kernel(), plain()
            if got != want:
                raise AssertionError(
                    f"the tally kernel says {got} and its plain version "
                    f"{want} on the widest {label} call as {kind}")
            h_rows = torch.zeros(krows.size, dtype=torch.uint8).pin_memory()
            d_rows = torch.empty_like(h_rows, device=qsets.top_mem.device)
            h_out = torch.zeros(1, dtype=torch.uint8).pin_memory()
            stream = torch.cuda.current_stream()

            def floor():
                d_rows.copy_(h_rows, non_blocking=True)
                torch.cuda._sleep(0)
                h_out.copy_(d_rows[:1], non_blocking=True)
                stream.synchronize()

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(LIVE_REPS):
                    kernel()
            device_us = [e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and e.name.startswith("quorum_tally")]
            read = sum(t.numel() * t.element_size()
                       for t in (*qsets, *local_qs)) + krows.size
            out[f"{label}.{kind}"] = {
                "n": int(rows.shape[-1]), "voters": voters,
                "live_kind": live_kind, "verdict": got,
                "equal_to_plain": True,
                "ms": cuda_ms(kernel, reps=LIVE_REPS),
                "plain_ms": cuda_ms(plain, reps=LIVE_REPS),
                "kernel_ms": (sum(device_us) / len(device_us) / 1e3
                              if device_us else None),
                "kernel_ms_samples": len(device_us),
                "bound_ms": cuda_ms(floor, reps=LIVE_REPS)
                + read / 3.35e12 * 1e3,
                "bound_bytes_read": read}
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card_line = card()
    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": card_line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.models import admission as A
    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
    from stellar_core_tpu_torch.ops import quorum as Q
    from stellar_core_tpu_torch.ops import quorum_cuda
    from stellar_core_tpu_torch.utils.device import pad_signature_batch

    # the tally kernel's launches, path by path (built at the first tally)
    tally_launches = LaunchCount(quorum_cuda)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = ed25519_cuda.build()
    ptxas = ed25519_cuda.ptxas_stats(built.log)
    shape = ed25519_cuda.launch_shape(pad_signature_batch(N_ROWS))
    emit({"phase": "build", "kernels": [ed25519_cuda.KERNEL],
          "seconds": time.perf_counter() - t0, "nvcc_seconds": built.seconds,
          "ptxas": ptxas, "main_path_launch": shape})
    if ptxas["spill_stores"] or ptxas["spill_loads"]:
        raise AssertionError(f"ed25519_verify_kernel spills: {ptxas}")

    # -- 3. kernel vs plain version, on the card -----------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pk, sg, mg = signed_triples(ref, sha256, rng)
    sign_s = time.perf_counter() - t0
    forged = np.arange(7, N_TRIPLES, 8)
    cpk, csg, cmg = forge(pk, sg, mg, forged)
    epk, esg, emg = edge_vectors(ref, sha256)
    cmp_in = [torch.as_tensor(np.concatenate([e, c]), device=dev)
              for e, c in ((epk, cpk), (esg, csg), (emg, cmg))]
    got = ed25519_cuda.verify_batch(*cmp_in)
    want = ed25519_kernel.verify_batch(*cmp_in)
    torch.cuda.synchronize()
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    n_cmp = got_np.shape[0]
    max_abs_err = int(np.abs(got_np.astype(np.int32)
                             - want_np.astype(np.int32)).max())
    if max_abs_err:
        bad = np.nonzero(got_np != want_np)[0][:10].tolist()
        raise AssertionError(f"kernel != plain version at rows {bad}")
    # every edge vector, plus random rows, up to 256
    sample = np.concatenate([np.arange(26), rng.choice(
        np.arange(26, n_cmp), min(230, n_cmp - 26), replace=False)])
    cmp_np = [t.cpu().numpy() for t in cmp_in]
    for r in sample:
        spec = ref.verify(cmp_np[0][r].tobytes(), cmp_np[1][r].tobytes(),
                          cmp_np[2][r].tobytes())
        if bool(got_np[r]) != spec:
            raise AssertionError(f"kernel != spec at row {r}")
    dsm_rows = check_double_scalar(ref, ed25519_cuda, rng, dev)
    emit({"phase": "compare", "rows": n_cmp, "edge_rows": 26,
          "forged_rows": int(forged.size), "accepted": int(got_np.sum()),
          "kernel_eq_plain": True, "spec_sample": int(sample.size),
          "double_scalar_special_rows": dsm_rows,
          "max_abs_err": max_abs_err, "sign_seconds": sign_s})

    # -- 4. main path at full size -------------------------------------------
    idx = np.arange(N_ROWS) % N_TRIPLES
    bad_rows = np.arange(7, N_ROWS, 8)
    tpk, tsg, tmg = forge(pk[idx], sg[idx], mg[idx], bad_rows)
    known = np.ones(N_ROWS, np.bool_)
    known[bad_rows] = False
    padded = pad_signature_batch(N_ROWS)
    pidx = np.arange(padded) % N_ROWS   # repeat real rows (tx_set.py)
    qsets = fba_topology()
    nodes = list(range(len(qsets)))
    qt = Q.build_qset_tensor(qsets, nodes, device=dev)
    rate = rng.uniform(0.3, 1.0, (N_CANDIDATES, 1))
    voted = rng.random((N_CANDIDATES, len(nodes))) < rate
    accepted = rng.random((N_CANDIDATES, len(nodes))) < rate * 0.4
    batch = A.batch_from_numpy(
        tpk[pidx], tsg[pidx], tmg[pidx], [t.cpu().numpy() for t in qt],
        [t[0].cpu().numpy() for t in qt], voted, accepted, dev)
    vt, at = batch.voted, batch.accepted

    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    t0 = time.perf_counter()
    sig_ok, accept, ratify = A.admission_step(batch)
    tally_acc, tally_rat = A.multi_validator_tally(qt, vt, at)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ed25519_cuda.launches
    if launches < 1:
        raise AssertionError("main path did not launch the ed25519 kernel")

    sig_np = sig_ok.cpu().numpy()
    if sig_np.shape != (padded,) or not np.array_equal(sig_np[:N_ROWS], known):
        raise AssertionError("sig_ok differs from the known forged mask")
    want_acc, want_rat = oracle_tally(qsets, voted, accepted)
    for name, g, w in (("accept", accept, want_acc[0]),
                       ("ratify", ratify, want_rat[0]),
                       ("tally_accept", tally_acc, want_acc),
                       ("tally_ratify", tally_rat, want_rat)):
        if not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError(f"{name} differs from the host oracle")
    emit({"phase": "main", "signatures": N_ROWS, "padded": padded,
          "accepted": int(sig_np[:N_ROWS].sum()), "validators": len(nodes),
          "candidates": N_CANDIDATES, "ratified": int(want_rat[0].sum()),
          "accepted_statements": int(want_acc[0].sum()),
          "launches": {ed25519_cuda.KERNEL: launches},
          "seconds": main_s, "exact": True})
    tally_launches.take("admission")

    # -- 5. live SCP: 64 validators externalize, envelopes through the kernel
    import stellar_core_tpu_torch.scp as scp_pkg
    from stellar_core_tpu_torch.scp.tally import TallyEngine, TallyMismatch
    from stellar_core_tpu_torch.xdr import types as xdr_types

    sizes: list = []
    verify = batch_verifier(ed25519_cuda.verify_batch, pad_signature_batch,
                            dev, sizes)
    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        with TallyProbe(TallyEngine) as probe:
            net, values, slot_s = run_scp(scp_pkg, xdr_types, ref, sha256,
                                          verify, SCP_SLOTS, device=dev)
    except TallyMismatch as e:
        raise AssertionError(f"tensor tally != host oracle: {e}") from e
    torch.cuda.synchronize()
    scp_s = time.perf_counter() - t0
    scp_launches = ed25519_cuda.launches
    engines = [s.tally for node in net.nodes for s in node.slots.values()]
    tallies = sum(e.tensor_tallies for e in engines)
    fallbacks = sum(e.host_fallbacks for e in engines)
    calls = probe.calls
    stats = net.stats
    if tallies <= 0 or fallbacks or tallies != sum(calls.values()):
        raise AssertionError(f"tensor tallies {tallies}, host fallbacks "
                             f"{fallbacks}")
    if scp_launches < 1 or scp_launches != stats["rounds"]:
        raise AssertionError(f"{scp_launches} verify launches for "
                             f"{stats['rounds']} delivery rounds")
    if stats["forged_refused"] != stats["rounds"] * len(net.nodes):
        raise AssertionError("a forged envelope was not refused")
    if tally_launches.take("scp") != tallies:
        raise AssertionError(f"{tally_launches.by_path['scp']} tally kernel "
                             f"launches for {tallies} tensor tallies")
    scp_widest = probe.widest
    device_s, oracle_s = probe.device_seconds, probe.oracle_seconds
    emit({"phase": "scp", "validators": len(net.nodes), "slots": SCP_SLOTS,
          "externalized": [v.hex() for v in values],
          "envelopes": stats["envelopes"], "delivery_rounds": stats["rounds"],
          "timers_fired": stats["timers_fired"],
          "accept_calls": calls["accept"], "ratify_calls": calls["ratify"],
          "tensor_tallies": tallies, "host_fallbacks": fallbacks,
          "tally_mismatches": 0, "verify_batches": len(sizes),
          "verify_batch_rows": stats["batch_sizes"],
          "verify_batch_padded": sizes,
          "launches": {ed25519_cuda.KERNEL: scp_launches,
                       quorum_cuda.KERNEL: tally_launches.by_path["scp"]},
          "forged_rows": stats["rounds"],
          "forged_refusals": stats["forged_refused"],
          "seconds_per_slot": slot_s, "seconds": scp_s,
          "reduced": {"slots": {"before": 2, "here": SCP_SLOTS}},
          "tally_device_seconds": device_s, "tally_oracle_seconds": oracle_s,
          "tally_device_ms_per_call": device_s / tallies * 1e3,
          "tally_oracle_ms_per_call": oracle_s / tallies * 1e3})

    # -- 6. quorum intersection ---------------------------------------------
    t0 = time.perf_counter()
    for line in quorum_intersection_phase(net, dev):
        emit(line)
    emit({"phase": "quorum_intersection", "seconds":
          time.perf_counter() - t0})
    tally_launches.take("quorum_intersection")

    # -- 7. node: a standalone node closes 1,000-payment ledgers ------------
    t0 = time.perf_counter()
    node_launches = node_phase(card_line, dev)
    emit({"phase": "node", "seconds": time.perf_counter() - t0})
    tally_launches.take("node")

    # -- 8. network: 21 validators over the loopback overlay -----------------
    net_launches, net_close_launches, net_tallies, net_widest = \
        network_phase(card_line, dev)
    if tally_launches.take("network") != net_tallies:
        raise AssertionError(f"{tally_launches.by_path['network']} tally "
                             f"kernel launches for {net_tallies} device "
                             f"tally calls of network A")

    # -- 9. bench: the headline bench at config #2's full size ---------------
    bench_launches, bench_batch = bench_phase(card_line, dev)
    tally_launches.take("bench")

    # -- 10. parallel: data-parallel admission -------------------------------
    parallel_launches = parallel_phase(card_line, bench_batch)
    tally_launches.take("parallel")
    del bench_batch

    # -- 11. cli: two node processes over TCP, driven over HTTP --------------
    cli_launches = cli_phase(card_line)
    tally_launches.take("cli")

    # -- 12. catchup: BASELINE config #4's replay ---------------------------
    catchup_launches = catchup_phase(card_line, dev)
    tally_launches.take("catchup")

    # -- 13. chaos: the scripted fault suite on core-4 -----------------------
    chaos_launches = chaos_phase(card_line, dev)
    tally_launches.take("chaos")

    # -- 14. fuzz: the committed repros on the card --------------------------
    fuzz_launches = fuzz_phase(card_line, dev)
    tally_launches.take("fuzz")

    # -- 15. tools: the port's benchmark tools on the card ------------------
    tools_launches = tools_phase(card_line)
    tally_launches.take("tools")

    # -- 16. netobs: the network observatory on a cuda and a cpu arm -------
    netobs_launches = netobs_phase(card_line)
    tally_launches.take("netobs")

    # -- 17. times -----------------------------------------------------------
    kin = (batch.pubkeys, batch.sigs, batch.msgs)
    kernel_ms = cuda_ms(lambda: ed25519_cuda.verify_batch(*kin))
    plain_full = ed25519_kernel.verify_batch(*kin)
    max_abs_err = max(max_abs_err, int(
        (plain_full.to(torch.int32) - sig_ok.to(torch.int32)).abs().max()))
    if max_abs_err:
        raise AssertionError("plain version differs from the kernel at "
                             f"{padded} rows")
    plain_ms = cuda_ms(lambda: ed25519_kernel.verify_batch(*kin), reps=2)
    small = tuple(t[:N_TRIPLES] for t in kin)
    kernel_ms_4096 = cuda_ms(lambda: ed25519_cuda.verify_batch(*small))
    plain_ms_4096 = cuda_ms(lambda: ed25519_kernel.verify_batch(*small),
                            reps=2)
    step_ms = cuda_ms(lambda: A.admission_step(batch))
    tally_ms = cuda_ms(lambda: A.multi_validator_tally(qt, vt, at))
    voters, kind, fn, args = probe.widest
    if voters != len(net.nodes):
        raise AssertionError(f"no live tally call had all {len(net.nodes)} "
                             f"validators voting (at most {voters})")
    live_ms = cuda_ms(lambda: fn(*args), reps=LIVE_REPS)
    live_counts = replay_counts(lambda: fn(*args), Q)
    tally_launches.take("times")
    tally_times = tally_kernel_times({"scp": scp_widest,
                                      "network": net_widest}, Q)
    t0 = time.perf_counter()
    bound_ms, bound_by, products = bound_ms_verify(
        ref, *(t.cpu().numpy() for t in kin))
    bound_s = time.perf_counter() - t0
    ref10_ms = bound_ms_ref10_count(padded)
    emit({"phase": "times", "card": card_line,
          "verify_kernel_ms": kernel_ms, "verify_rows": padded,
          "verify_sigs_per_s": padded / kernel_ms * 1e3,
          "verify_kernel_ms_4096": kernel_ms_4096,
          "plain_verify_ms": plain_ms, "plain_verify_ms_4096": plain_ms_4096,
          "admission_step_ms": step_ms,
          "admission_real_sigs_per_s": N_ROWS / step_ms * 1e3,
          "multi_validator_tally_ms": tally_ms,
          "live_tally_ms": live_ms, "live_tally_kind": kind,
          "live_tally_voters": voters,
          "live_tally_universe": int(args[2].shape[-1]),
          "live_tally_replay": live_counts,
          "verify_bound_ms": bound_ms, "bound_by": bound_by,
          "bound_products": products, "bound_seconds": bound_s,
          "verify_share_of_bound": bound_ms / kernel_ms,
          "verify_bound_ms_ref10_count": ref10_ms,
          "reps": REPS, "plain_reps": 2,
          "total_seconds": time.perf_counter() - t_start})

    net_kind = "accept" if "network.accept" in tally_times else "ratify"
    net_tally = tally_times[f"network.{net_kind}"]
    emit({"kernels": [{
        "name": ed25519_cuda.KERNEL, "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519_pallas.py:364",
        "launches": (launches + scp_launches + node_launches
                     + net_launches + net_close_launches + bench_launches
                     + parallel_launches + cli_launches + catchup_launches
                     + chaos_launches + fuzz_launches + tools_launches
                     + netobs_launches),
        "launches_by_path": {"admission": launches, "scp": scp_launches,
                             "node": node_launches, "network": net_launches,
                             "network_close": net_close_launches,
                             "bench": bench_launches,
                             "parallel": parallel_launches,
                             "cli": cli_launches,
                             "catchup": catchup_launches,
                             "chaos": chaos_launches,
                             "fuzz": fuzz_launches,
                             "tools": tools_launches,
                             "netobs": netobs_launches},
        "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_ms_ref10_count": ref10_ms,
        "registers": ptxas["registers"],
        "spill_bytes": ptxas["spill_stores"] + ptxas["spill_loads"],
        "stack_frame_bytes": ptxas["stack_frame_bytes"],
        "blocks_per_sm": shape["blocks_per_sm"]}, {
        "name": quorum_cuda.KERNEL, "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/quorum_tally.cu",
        "replaces": None,
        "launches": sum(tally_launches.by_path.values()),
        "launches_by_path": tally_launches.by_path,
        "max_abs_err": 0, "ms": net_tally["ms"],
        "plain_ms": net_tally["plain_ms"],
        "bound_ms": net_tally["bound_ms"],
        "bound_by": "one copy in, one launch, one copy out, one sync",
        "library_ms": None, "kernel_ms": net_tally["kernel_ms"],
        "shape": f"network.{net_kind}", "by_call": tally_times}]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
