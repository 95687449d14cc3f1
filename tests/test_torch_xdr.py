"""The port's XDR against the JAX package's: the same seeded values (plain
numpy-drawn descriptions, built into each package's XDR objects) must
encode to the same bytes, decode back to themselves, and hash alike.
Covers every SCPStatement pledge arm with its optional fields present and
absent, SCPEnvelope, and SCPQuorumSets nested up to 4 levels.  Objects of
two packages never compare equal, so only bytes are compared.
Tolerance: byte equality."""
import numpy as np
import pytest

from stellar_core_tpu.xdr import types as JT, xdr_sha256 as jax_sha256
from stellar_core_tpu_torch.xdr import XdrError, types as PT, xdr_sha256

PACKAGES = {"jax": (JT, jax_sha256), "port": (PT, xdr_sha256)}
ARMS = ("prepare", "confirm", "externalize", "nominate")


# -- seeded plain descriptions ----------------------------------------------

def _value(rng):
    return rng.bytes(int(rng.integers(0, 80)))


def _ballot(rng, present=True):
    if not present:
        return None
    return (int(rng.integers(0, 2**32)), _value(rng))


def _statement_desc(rng, arm, optional):
    """(node, slot, arm, fields) with every optional field present or
    absent as ``optional`` says (nominate: empty or full lists)."""
    node, slot, qh = rng.bytes(32), int(rng.integers(0, 2**63)) * 2 + 1, \
        rng.bytes(32)
    u32 = lambda: int(rng.integers(0, 2**32))  # noqa: E731
    if arm == "prepare":
        fields = dict(quorumSetHash=qh, ballot=_ballot(rng),
                      prepared=_ballot(rng, optional),
                      preparedPrime=_ballot(rng, optional), nC=u32(),
                      nH=u32())
    elif arm == "confirm":
        fields = dict(ballot=_ballot(rng), nPrepared=u32(), nCommit=u32(),
                      nH=u32(), quorumSetHash=qh)
    elif arm == "externalize":
        fields = dict(commit=_ballot(rng), nH=u32(), commitQuorumSetHash=qh)
    else:
        n = int(rng.integers(1, 6)) if optional else 0
        fields = dict(quorumSetHash=qh,
                      votes=sorted(_value(rng) for _ in range(n)),
                      accepted=sorted(_value(rng) for _ in range(n // 2)))
    return node, slot, arm, fields


def _qset_desc(rng, depth):
    """A quorum set ``depth`` levels deep (1 = validators only)."""
    vals = [rng.bytes(32) for _ in range(int(rng.integers(0, 5)))]
    inners = [] if depth == 1 else [
        _qset_desc(rng, depth - 1) for _ in range(int(rng.integers(1, 4)))]
    thr = int(rng.integers(0, len(vals) + len(inners) + 1))
    return thr, vals, inners


# -- build one description in one package ------------------------------------

def _xdr_ballot(T, b):
    return None if b is None else T.SCPBallot.make(counter=b[0], value=b[1])


def _statement(T, desc):
    node, slot, arm, fields = desc
    st_type = getattr(T.SCPStatementType, "SCP_ST_" + arm.upper())
    kw = {k: (_xdr_ballot(T, v) if isinstance(v, tuple) or v is None
              else v) for k, v in fields.items()}
    body = T.SCPStatementPledges.arms[st_type][1].make(**kw)
    return T.SCPStatement.make(
        nodeID=T.account_id(node), slotIndex=slot,
        pledges=T.SCPStatementPledges.make(st_type, body))


def _qset(T, desc):
    thr, vals, inners = desc
    return T.SCPQuorumSet.make(threshold=thr,
                               validators=[T.account_id(v) for v in vals],
                               innerSets=[_qset(T, i) for i in inners])


def _encodings(build, xdr_type_name, desc):
    out = {}
    for name, (T, _) in PACKAGES.items():
        xdr_type = getattr(T, xdr_type_name)
        value = build(T, desc)
        data = xdr_type.encode(value)
        # round trip within each package: decode, encode again
        assert xdr_type.encode(xdr_type.decode(data)) == data
        out[name] = data
    return out


@pytest.mark.parametrize("optional", [True, False],
                         ids=["optional_present", "optional_absent"])
@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("seed", range(3))
def test_statement_arms_encode_to_the_jax_bytes(seed, arm, optional):
    rng = np.random.default_rng(1000 + seed)
    desc = _statement_desc(rng, arm, optional)
    enc = _encodings(_statement, "SCPStatement", desc)
    assert enc["port"] == enc["jax"]
    st = PT.SCPStatement.decode(enc["port"])
    assert st.pledges.type == getattr(PT.SCPStatementType,
                                      "SCP_ST_" + arm.upper())
    if arm == "prepare":
        assert (st.pledges.value.prepared is None) == (not optional)


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("seed", range(2))
def test_envelope_encodes_to_the_jax_bytes(seed, arm):
    rng = np.random.default_rng(2000 + seed)
    desc = (_statement_desc(rng, arm, bool(seed)), rng.bytes(64))

    def envelope(T, d):
        return T.SCPEnvelope.make(statement=_statement(T, d[0]),
                                  signature=d[1])

    enc = _encodings(envelope, "SCPEnvelope", desc)
    assert enc["port"] == enc["jax"]
    env = PT.SCPEnvelope.decode(enc["port"])
    assert env.signature == desc[1]
    assert PT.SCPStatement.encode(env.statement) == JT.SCPStatement.encode(
        JT.SCPEnvelope.decode(enc["jax"]).statement)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_nested_qsets_encode_and_hash_to_the_jax_bytes(seed, depth):
    rng = np.random.default_rng(3000 + 10 * depth + seed)
    desc = _qset_desc(rng, depth)
    enc = _encodings(_qset, "SCPQuorumSet", desc)
    assert enc["port"] == enc["jax"]
    hashes = {name: sha(T.SCPQuorumSet, _qset(T, desc))
              for name, (T, sha) in PACKAGES.items()}
    assert hashes["port"] == hashes["jax"] and len(hashes["port"]) == 32


def test_decode_refuses_what_the_jax_decoder_refuses():
    """Truncated and trailing bytes, a bad optional flag and a bad union
    discriminant fail in both packages."""
    rng = np.random.default_rng(4000)
    data = _statement(PT, _statement_desc(rng, "prepare", True))
    good = PT.SCPStatement.encode(data)
    flag_at = 32 + 4 + 8 + 4 + 32 + 8 + len(data.pledges.value.ballot.value)
    flag_at += (-flag_at) % 4
    bad_flag = good[:flag_at] + b"\x00\x00\x00\x02" + good[flag_at + 4:]
    bad_arm = good[:44] + b"\x00\x00\x00\x09" + good[48:]
    for blob in (good[:-1], good + b"\x00" * 4, bad_flag, bad_arm):
        for T, exc in ((PT, XdrError), (JT, Exception)):
            with pytest.raises(exc):
                T.SCPStatement.decode(blob)
