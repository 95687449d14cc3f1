"""The port's SCP against the JAX package's, on the CPU (the port's tally
on ``device="cpu"``).

1. The 9 scripted cases of tests/test_scp.py, driven identically in both
   packages by the driver below: the same emitted envelope bytes in
   order, receive verdicts and externalized values, for the port's
   ``host`` and ``tensor`` tally backends against the JAX package's host
   tallies.
2. Signed in-process networks of 4 and 16 validators (``chip_smoke.
   Network``, the scaffolding of the chip run's ``scp`` phase) over 2
   slots: the same emitted bytes, delivery rounds and externalized values
   as the JAX package with ``tally_backend="host"``; the port's ``both``
   backend raises no ``TallyMismatch``.
3. A 3-level quorum set falls back to the host with the same
   ``host_fallbacks`` as the JAX engine.
4. A tensor backend with no device given raises where there is no GPU, and
   ``TallyEngine`` takes the reference's ``(slot, backend)`` call (C5).
5. The tally engine's tensor cache: its key equals the JAX engine's for
   the same envelopes, it keeps no qset object over many builds with
   fresh qset objects, and the port's detlint finds ``scp/tally.py``
   clean (and finds an ``id()``-keyed memo injected into it).

Tolerance: byte equality of envelopes, equality of values and counters."""
import functools
import hashlib
from types import SimpleNamespace

import pytest
import torch

import stellar_core_tpu.scp as JS
import stellar_core_tpu_torch.scp as PS
from chip_smoke import Network, TallyProbe, fba_xdr_qset
from stellar_core_tpu.xdr import types as JT
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.scp.tally import TallyEngine
from stellar_core_tpu_torch.xdr import types as PT

V = [bytes([i + 1]) * 32 for i in range(5)]  # node ids v0..v4
X = hashlib.sha256(b"value-x").digest()
Y = hashlib.sha256(b"value-y").digest()
PREV = hashlib.sha256(b"prev").digest()

PACKAGES = {"jax": (JS, JT), "port": (PS, PT)}


class _ScriptDriver:
    """tests/test_scp.py's TestDriver, for either package."""

    def __init__(self, qset, qset_hash, validation_level):
        self.qsets = {qset_hash(qset): qset}
        self.emitted = []
        self.externalized = {}
        self.timers = {}
        self.priority_node = V[0]
        self._level = validation_level

    def validate_value(self, slot_index, value, nomination):
        return self._level.FULLY_VALIDATED

    def combine_candidates(self, slot_index, candidates):
        return max(candidates)

    def sign_envelope(self, env):
        env.signature = b"\x01" * 64

    def verify_envelope(self, env):
        return True

    def emit_envelope(self, env):
        self.emitted.append(env)

    def get_qset(self, h):
        return self.qsets.get(h)

    def compute_hash_node(self, slot_index, prev, is_priority, round_num,
                          node_id):
        if is_priority:
            return 2**63 if node_id == self.priority_node else 1
        return 0

    def setup_timer(self, slot_index, timer_id, timeout, cb):
        self.timers[(slot_index, timer_id)] = (timeout, cb)

    def value_externalized(self, slot_index, value):
        self.externalized[slot_index] = value


class Script:
    """One scripted SCP instance of one package: v0 local, 5 nodes; a log
    of every receive verdict, in order."""

    def __init__(self, package, backend="host", qset=None):
        S, T = self.S, self.T = PACKAGES[package]
        self.ST = SimpleNamespace(**{
            k: getattr(T.SCPStatementType, "SCP_ST_" + k)
            for k in ("PREPARE", "CONFIRM", "EXTERNALIZE", "NOMINATE")})
        qset = qset(S.make_qset) if qset else S.make_qset(4, V)
        cls = type("ScriptDriver", (_ScriptDriver, S.SCPDriver), {})
        self.driver = cls(qset, S.qset_hash, S.ValidationLevel)
        kw = {"tally_backend": backend}
        if package == "port" and backend != "host":
            kw["device"] = "cpu"
        self.scp = S.SCP(self.driver, V[0], True, qset, **kw)
        self.qh = S.qset_hash(qset)
        self.log = []

    # envelopes, as tests/test_scp.py builds them
    def envelope(self, node, slot, type_, arm):
        T = self.T
        st = T.SCPStatement.make(nodeID=T.account_id(node), slotIndex=slot,
                                 pledges=T.SCPStatementPledges.make(type_,
                                                                    arm))
        return T.SCPEnvelope.make(statement=st, signature=b"\x01" * 64)

    def ballot(self, b):
        return None if b is None else self.T.SCPBallot.make(counter=b[0],
                                                            value=b[1])

    def prepare(self, node, ballot, prepared=None, nC=0, nH=0, slot=1,
                qh=None):
        arm = self.T.SCPStatementPledges.arms[self.ST.PREPARE][1].make(
            quorumSetHash=qh or self.qh, ballot=self.ballot(ballot),
            prepared=self.ballot(prepared), preparedPrime=None, nC=nC, nH=nH)
        return self.envelope(node, slot, self.ST.PREPARE, arm)

    def confirm(self, node, ballot, n_prepared, n_commit, n_h, slot=1):
        arm = self.T.SCPStatementPledges.arms[self.ST.CONFIRM][1].make(
            ballot=self.ballot(ballot), nPrepared=n_prepared,
            nCommit=n_commit, nH=n_h, quorumSetHash=self.qh)
        return self.envelope(node, slot, self.ST.CONFIRM, arm)

    def externalize(self, node, commit, n_h, slot=1):
        arm = self.T.SCPStatementPledges.arms[self.ST.EXTERNALIZE][1].make(
            commit=self.ballot(commit), nH=n_h, commitQuorumSetHash=self.qh)
        return self.envelope(node, slot, self.ST.EXTERNALIZE, arm)

    def nominate_env(self, node, votes, accepted=(), slot=1):
        arm = self.T.SCPNomination.make(quorumSetHash=self.qh,
                                        votes=sorted(votes),
                                        accepted=sorted(accepted))
        return self.envelope(node, slot, self.ST.NOMINATE, arm)

    def recv(self, env):
        res = self.scp.receive_envelope(env)
        self.log.append(int(res))
        return res

    def last(self, type_):
        for env in reversed(self.driver.emitted):
            if env.statement.pledges.type == type_:
                return env.statement.pledges.value
        return None

    def result(self):
        return {"emitted": [self.T.SCPEnvelope.encode(e)
                            for e in self.driver.emitted],
                "externalized": sorted(self.driver.externalized.items()),
                "log": self.log}


# -- the 9 scripted cases of tests/test_scp.py -------------------------------

def case_prepare_to_externalize(c):
    slot = c.scp.get_slot(1)
    b1 = (1, X)
    assert slot.bump_state(X, True)
    for v in V[1:4]:
        c.recv(c.prepare(v, b1))
    assert c.last(c.ST.PREPARE).prepared.value == X
    for v in V[1:4]:
        c.recv(c.prepare(v, b1, prepared=b1))
    p = c.last(c.ST.PREPARE)
    assert p.nH == 1 and p.nC == 1
    for v in V[1:4]:
        c.recv(c.prepare(v, b1, prepared=b1, nC=1, nH=1))
    assert slot.ballot.phase == c.S.Phase.CONFIRM
    for v in V[1:4]:
        c.recv(c.confirm(v, b1, 1, 1, 1))
    assert slot.ballot.phase == c.S.Phase.EXTERNALIZE
    assert c.driver.externalized[1] == X


def case_rejects_stale_statements(c):
    c.scp.get_slot(1)
    e1 = c.prepare(V[1], (2, X))
    assert c.recv(e1).name == "VALID"
    assert c.recv(e1).name == "INVALID"
    assert c.recv(c.prepare(V[1], (1, X))).name == "INVALID"


def case_vblocking_bump(c):
    slot = c.scp.get_slot(1)
    slot.bump_state(X, True)
    for v in V[1:3]:
        c.recv(c.prepare(v, (3, X)))
    assert slot.ballot.current[0] == 3


def case_externalize_short_circuit(c):
    slot = c.scp.get_slot(1)
    for v in V[1:]:
        c.recv(c.externalize(v, (1, X), 1))
    assert slot.ballot.phase == c.S.Phase.EXTERNALIZE
    assert c.driver.externalized[1] == X


def case_nomination_to_ballot(c):
    slot = c.scp.get_slot(1)
    assert c.scp.nominate(1, X, PREV)
    assert list(c.last(c.ST.NOMINATE).votes) == [X]
    for v in V[1:4]:
        c.recv(c.nominate_env(v, [X]))
    assert list(c.last(c.ST.NOMINATE).accepted) == [X]
    for v in V[1:4]:
        c.recv(c.nominate_env(v, [X], accepted=[X]))
    assert slot.nomination.candidates == {X}
    p = c.last(c.ST.PREPARE)
    assert (p.ballot.counter, p.ballot.value) == (1, X)


def case_nomination_echoes_leader_votes(c):
    c.driver.priority_node = V[1]
    slot = c.scp.get_slot(1)
    c.scp.nominate(1, X, PREV)
    assert c.last(c.ST.NOMINATE) is None
    c.recv(c.nominate_env(V[1], [Y]))
    assert list(c.last(c.ST.NOMINATE).votes) == [Y]
    assert slot.nomination.votes == {Y}


def case_nomination_non_leader_values_ignored(c):
    c.driver.priority_node = V[1]
    c.scp.nominate(1, X, PREV)
    c.recv(c.nominate_env(V[2], [Y]))
    assert c.last(c.ST.NOMINATE) is None


def case_timer_armed_on_quorum_heard(c):
    slot = c.scp.get_slot(1)
    slot.bump_state(X, True)
    for v in V[1:4]:
        c.recv(c.prepare(v, (1, X)))
    assert slot.ballot.heard_from_quorum
    timeout, cb = c.driver.timers[(1, c.S.BALLOT_TIMER)]
    assert timeout > 0 and cb is not None
    cb()
    assert slot.ballot.current[0] == 2


def case_bad_qset_hash_rejected(c):
    res = c.recv(c.prepare(V[1], (1, X), qh=b"\x77" * 32))
    assert res.name == "INVALID"


CASES = [case_prepare_to_externalize, case_rejects_stale_statements,
         case_vblocking_bump, case_externalize_short_circuit,
         case_nomination_to_ballot, case_nomination_echoes_leader_votes,
         case_nomination_non_leader_values_ignored,
         case_timer_armed_on_quorum_heard, case_bad_qset_hash_rejected]


@functools.cache
def _jax_script(case_name):
    c = Script("jax")
    globals()[case_name](c)
    return c.result()


@functools.cache
def _jax_tensor_tallies(case_name):
    """The JAX engine's (tensor_tallies, host_fallbacks) on the case."""
    c = Script("jax", "tensor")
    globals()[case_name](c)
    tally = c.scp.get_slot(1).tally
    return tally.tensor_tallies, tally.host_fallbacks


@pytest.mark.parametrize("backend", ["host", "tensor"])
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_scripted_case_matches_jax(case, backend):
    c = Script("port", backend)
    case(c)
    got = c.result()
    assert got == _jax_script(case.__name__)
    tally = c.scp.get_slot(1).tally
    if backend == "host":
        assert tally is None
    else:
        assert (tally.tensor_tallies, tally.host_fallbacks) == \
            _jax_tensor_tallies(case.__name__)
        assert tally.host_fallbacks == 0


# -- signed networks ----------------------------------------------------------

@functools.cache
def _public(seed):
    return ref.public_from_seed(seed)


@functools.cache
def _sign(seed, msg):
    return ref.sign(seed, msg)


@functools.cache
def _verify_one(triple):
    return ref.verify(*triple)


def _verify(triples):
    return [_verify_one(t) for t in triples]


TOPOLOGIES = {
    4: lambda make_qset, ids: make_qset(3, ids),
    16: functools.partial(fba_xdr_qset, org_size=4, top_thr=3, inner_thr=3),
}


def _network(package, n, backend="host", slots=2):
    S, T = PACKAGES[package]
    kw = {} if package == "jax" else {"tally_backend": backend,
                                      "device": "cpu"}
    seeds = [sha256(b"net-node%d" % i) for i in range(n)]
    net = Network(S, T, seeds, TOPOLOGIES[n], _sign, _public, sha256,
                  _verify, scp_kwargs=kw)
    prev, values = bytes(32), []
    for slot in range(1, slots + 1):
        prev = net.run_slot(slot, prev)
        values.append(prev)
    stats = {k: net.stats[k] for k in ("rounds", "envelopes", "batch_sizes",
                                       "forged_refused", "timers_fired")}
    return net, {"emitted": net.emitted, "values": values, "stats": stats}


@functools.cache
def _jax_network(n):
    return _network("jax", n)[1]


@pytest.mark.parametrize("backend", ["host", "both"])
@pytest.mark.parametrize("n", [4, 16])
def test_network_matches_jax(n, backend):
    with TallyProbe(TallyEngine) as probe:
        net, got = _network("port", n, backend)
    want = _jax_network(n)
    assert got == want
    assert len(set(want["values"])) == 2
    assert want["stats"]["forged_refused"] == want["stats"]["rounds"] * n
    for node in net.nodes:
        assert [node.get_externalized_value(s) for s in (1, 2)] == \
            want["values"]
    if backend == "both":
        engines = [s.tally for node in net.nodes
                   for s in node.slots.values()]
        tallies = sum(e.tensor_tallies for e in engines)
        assert tallies == sum(probe.calls.values()) > 0
        assert sum(e.host_fallbacks for e in engines) == 0
        assert probe.oracle_seconds > 0
        voters, kind, fn, args = probe.widest
        assert voters == n and kind in probe.calls
        assert fn(*args) in (True, False)
    else:
        assert probe.calls == {"accept": 0, "ratify": 0}
        assert probe.widest is None
    assert TallyEngine.device_accept.__name__ == "device_accept"


# -- 3-level quorum sets, and the device rule --------------------------------

def _three_level(make_qset):
    """2 of {v0, v1, (1 of {v2, (2 of {v3, v4})})}: no tensor form."""
    return make_qset(2, V[:2], [make_qset(1, V[2:3],
                                          [make_qset(2, V[3:5])])])


def _drive_three_level(c):
    slot = c.scp.get_slot(1)
    slot.bump_state(X, True)
    for v in V[1:4]:
        c.recv(c.prepare(v, (1, X)))
    for v in V[1:4]:
        c.recv(c.prepare(v, (1, X), prepared=(1, X)))
    for v in V[1:4]:
        c.recv(c.prepare(v, (1, X), prepared=(1, X), nC=1, nH=1))
    for v in V[1:4]:
        c.recv(c.confirm(v, (1, X), 1, 1, 1))
    return slot


def test_three_level_qset_falls_back_like_the_jax_engine():
    jc = Script("jax", "tensor", qset=_three_level)
    pc = Script("port", "tensor", qset=_three_level)
    jslot, pslot = _drive_three_level(jc), _drive_three_level(pc)
    assert pc.result() == jc.result()
    assert pc.driver.externalized == {1: X}
    assert pslot.tally.host_fallbacks == jslot.tally.host_fallbacks > 0
    assert pslot.tally.tensor_tallies == jslot.tally.tensor_tallies == 0


@pytest.mark.parametrize("backend", ["tensor", "both"])
def test_tensor_backend_without_device_raises_without_gpu(backend):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    qset = PS.make_qset(4, V)
    drv = type("D", (_ScriptDriver, PS.SCPDriver), {})(
        qset, PS.qset_hash, PS.ValidationLevel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.SCP(drv, V[0], True, qset, tally_backend=backend)
    host = PS.SCP(drv, V[0], True, qset)
    assert host.tally_device is None and host.get_slot(1).tally is None


def test_tally_engine_takes_the_reference_signature():
    """``TallyEngine(slot, backend, device=None)``, as the JAX engine is
    called with ``(slot, backend)``: a tensor engine with no device
    resolves the default device (raising where there is no GPU, never a
    TypeError), a host engine needs none, and ``device="cpu"`` tallies as
    the JAX engine does."""
    from stellar_core_tpu.scp.tally import TallyEngine as JaxTallyEngine

    pnet, _ = _network("port", 4, "host")
    jnet, _ = _network("jax", 4)
    (_, pslot, penv), (_, jslot, jenv) = (_slot_envelopes(pnet)[0],
                                          _slot_envelopes(jnet)[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TallyEngine(pslot, "tensor")
    host = TallyEngine(pslot, "host")
    assert host.device is None
    assert host.federated_ratify(lambda st: True, penv) is None
    eng, je = TallyEngine(pslot, "tensor", "cpu"), JaxTallyEngine(jslot,
                                                                   "tensor")
    assert eng.device == torch.device("cpu")
    for voted in (lambda st: True, lambda st: False):
        assert eng.federated_ratify(voted, penv) == \
            je.federated_ratify(voted, jenv) is not None
        assert eng.federated_accept(voted, voted, penv) == \
            je.federated_accept(voted, voted, jenv) is not None
    assert eng._cache_key == je._cache_key
    assert eng.tensor_tallies == je.tensor_tallies == 4


# -- the tensor cache's key --------------------------------------------------

def _slot_envelopes(net, slot_index=1):
    """(node, slot, the slot's latest ballot envelopes) of every node."""
    return [(node, node.slots[slot_index],
             dict(node.slots[slot_index].ballot.latest_envelopes))
            for node in net.nodes]


def test_cache_key_equals_the_jax_engines():
    from stellar_core_tpu.scp.tally import TallyEngine as JaxTallyEngine

    jnet, _ = _network("jax", 4)
    pnet, _ = _network("port", 4, "host")
    keys = []
    for (_, jslot, jenv), (_, pslot, penv) in zip(_slot_envelopes(jnet),
                                                   _slot_envelopes(pnet)):
        assert sorted(jenv) == sorted(penv) and len(penv) == 4
        je = JaxTallyEngine(jslot, "tensor")
        pe = TallyEngine(pslot, "tensor", torch.device("cpu"))
        assert je._build(jenv) is not None and pe._build(penv) is not None
        assert pe._cache_key == je._cache_key
        keys.append(pe._cache_key)
    assert len(keys) == 4 and all(len(k) == 4 for k in keys)


def _owned(obj, depth=4) -> set:
    """ids of the containers reachable from ``obj``'s attributes."""
    seen, todo = set(), [(vars(obj), 0)]
    while todo:
        x, d = todo.pop()
        if id(x) in seen or d > depth:
            continue
        seen.add(id(x))
        if isinstance(x, dict):
            todo += [(v, d + 1) for v in x.values()]
        elif isinstance(x, (list, tuple, set, frozenset)):
            todo += [(v, d + 1) for v in x]
    return seen


def test_engine_keeps_no_qset_objects_over_fresh_ones(monkeypatch):
    import gc

    net, _ = _network("port", 4, "host")
    _, slot, envs = _slot_envelopes(net)[0]
    eng = TallyEngine(slot, "tensor", torch.device("cpu"))
    real = slot.qset_from_statement
    fresh = []

    def qset_from_statement(st):
        q = real(st)
        q = PT.SCPQuorumSet.decode(PT.SCPQuorumSet.encode(q))
        fresh.append(q)
        return q

    monkeypatch.setattr(slot, "qset_from_statement", qset_from_statement)

    def held():
        return sum(len(v) for v in vars(eng).values()
                   if isinstance(v, (dict, list, set, tuple)))

    first = eng._build(envs)
    size = held()
    for _ in range(50):
        assert eng._build(envs) is first   # the same key: the cached tensors
    assert held() == size
    assert len(fresh) == 51 * len(envs)
    owned = _owned(eng)
    for q in fresh[-len(envs):]:
        assert not any(id(r) in owned for r in gc.get_referrers(q))


def test_port_detlint_finds_the_tally_module_clean():
    import subprocess
    import sys

    from stellar_core_tpu_torch.tools.lint import lint_sources
    from stellar_core_tpu_torch.tools.lint.engine import REPO

    rel = "stellar_core_tpu_torch/scp/tally.py"
    res = subprocess.run([sys.executable, "-m",
                          "stellar_core_tpu_torch.tools.lint", "--strict",
                          rel], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 findings" in res.stdout
    # an id()-keyed memo feeding the cache key goes red
    with open(f"{REPO}/{rel}", encoding="utf-8") as fh:
        src = fh.read()
    old = "        key = tuple(sorted(node_hashes.items()))\n"
    assert src.count(old) == 1
    method = "    def device_accept("
    assert src.count(method) == 1
    bad = src.replace(old, (
        "        key = tuple(sorted(\n"
        "            (n, self._memo(q)) for n, q in node_qsets.items()))\n"
    )).replace(method, (
        "    def _memo(self, q):\n"
        "        ent = self._seen.get(id(q))\n"
        "        if ent is None:\n"
        "            ent = self._seen[id(q)] = (q, LN.qset_hash(q))\n"
        "        return ent[1]\n\n" + method))
    findings = lint_sources({rel: bad})
    assert any(f.rule == "det-interproc-taint" and "id()" in f.message
               for f in findings), [f.render() for f in findings]
