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
               externalize 2 slots over an all-to-all bus; each delivery round's envelope signatures
               (plus one forged copy) go through the verify kernel as one
               padded batch.  Every node must externalize one common
               value per slot, no tensor tally may differ from the host
               oracle, none may fall back to the host, every forged
               envelope must be refused, and the kernel must have been
               launched once per round;
  6. times   — CUDA-event times (warm-up excluded) with the card's name
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
SCP_SLOTS = 2         # slots the 64-validator network externalizes
LIVE_REPS = 50        # replays of one recorded live tally call
MAX_ROUNDS = 10_000   # delivery rounds before a network counts as stuck
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
    return [np.frombuffer(b"".join(v[i] for v in out), np.uint8).reshape(
        len(out), w) for i, w in enumerate((32, 64, 32))]


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
    def verify(triples):
        n = len(triples)
        cols = [np.frombuffer(b"".join(t[j] for t in triples),
                              np.uint8).reshape(n, w)
                for j, w in enumerate((32, 64, 32))]
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
    the contraction trips it runs (``quorum_ops._contract_trip`` counted),
    and from torch.profiler the CUDA runtime calls by name
    (``cudaLaunchKernel``, copies, synchronizations) and the device-side
    kernels and copies.  Profiler counts are ``None`` where it saw no CUDA
    activity."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
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
    return {"trips": len(trips), "runtime_calls": dict(runtime) or None,
            "device_kernels": len(device) - copies if device else None,
            "device_copies": copies if device else None}


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
    from stellar_core_tpu_torch.utils.device import pad_signature_batch

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
          "launches": {ed25519_cuda.KERNEL: scp_launches},
          "forged_rows": stats["rounds"],
          "forged_refusals": stats["forged_refused"],
          "seconds_per_slot": slot_s, "seconds": scp_s,
          "tally_device_seconds": device_s, "tally_oracle_seconds": oracle_s,
          "tally_device_ms_per_call": device_s / tallies * 1e3,
          "tally_oracle_ms_per_call": oracle_s / tallies * 1e3})

    # -- 6. times ------------------------------------------------------------
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

    emit({"kernels": [{
        "name": ed25519_cuda.KERNEL, "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519_pallas.py:364",
        "launches": launches + scp_launches,
        "launches_by_path": {"admission": launches, "scp": scp_launches},
        "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_ms_ref10_count": ref10_ms,
        "registers": ptxas["registers"],
        "spill_bytes": ptxas["spill_stores"] + ptxas["spill_loads"],
        "stack_frame_bytes": ptxas["stack_frame_bytes"],
        "blocks_per_sm": shape["blocks_per_sm"]}]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
