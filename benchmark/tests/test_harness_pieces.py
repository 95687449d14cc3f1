"""The benchmark's frozen copies and arithmetic against their origins:
the traffic's bytes against the port's decoder and signature checks, the
verify kernel's operation count against ``chip_smoke.py``, the trace
reduction on intervals worked out by hand, the network's quorum set
against stellar-core's rule, and the stop of a window that outruns its
traffic."""
import numpy as np
import pytest

from benchmark import harness
from benchmark import traffic as tr
from benchmark.reference import ed25519 as ref
from benchmark.reference import verify_work
from benchmark.trace import Intervals

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def envs():
    t = tr.Traffic(SEED, "Standalone Network ; February 2017", 16, 10**10,
                   1000)
    return t, t.payments(range(16), [(3 << 32) + 1] * 16, 4)


def test_envelopes_decode_on_the_port(envs):
    from stellar_core_tpu_torch.crypto import ed25519_ref
    from stellar_core_tpu_torch.transactions.frame import \
        tx_frame_from_envelope
    from stellar_core_tpu_torch.xdr import types as T

    t, es = envs
    for e in es:
        f = tx_frame_from_envelope(t.net_id, T.TransactionEnvelope.decode(
            e.wire))
        assert f.full_hash() == e.hash and f.seq_num() == e.seq
        assert f.source_account_id() == e.pub
        assert ed25519_ref.verify(e.pub, e.sig, e.hash) == (not e.forged)
        assert ref.verify(e.pub, e.sig, e.hash) == (not e.forged)
    assert sum(e.forged for e in es) == 4
    xs = T.TransactionSet.decode(tr.tx_set(b"\1" * 32, [e.wire for e in es]))
    assert len(xs.txs) == 16


def test_root_key_is_the_ports():
    from stellar_core_tpu_torch.crypto import SecretKey

    net = tr.network_id("Standalone Network ; February 2017")
    assert tr.root_key(net)[1] == SecretKey(net).public_key().raw
    t = tr.Traffic(SEED, "Standalone Network ; February 2017", 3, 10**9, 9)
    c = t.create_accounts(0)[0]
    assert ref.verify(c.pub, c.sig, c.hash)


def test_operation_count_equals_chip_smoke(envs):
    import chip_smoke
    from stellar_core_tpu_torch.crypto import ed25519_ref

    _, es = envs
    cols = [np.stack([np.frombuffer(b, np.uint8) for b in col])
            for col in zip(*[(e.pub, e.sig, e.hash) for e in es])]
    assert verify_work.bound_ms_verify(ref, *cols) == \
        chip_smoke.bound_ms_verify(ed25519_ref, *cols)


def test_intervals_overlap():
    busy = Intervals([(10, 20), (15, 30), (40, 50)])
    assert busy.starts == [10, 40] and busy.ends == [30, 50]
    assert busy.overlap(0, 100) == 30
    assert busy.overlap(12, 45) == 23
    assert busy.overlap(30, 40) == 0
    assert busy.overlap(41, 42) == 1
    assert Intervals([]).overlap(0, 5) == 0


def test_tier1_quorum_set_is_stellar_cores_generated_one():
    from benchmark.drivers.network import links, quorum_set

    cfg = harness.config("tier1_net")["topology"]
    orgs = [[bytes([o, k]) for k in range(cfg["per_org"])]
            for o in range(cfg["orgs"])]
    q = quorum_set(orgs)
    assert q["threshold"] == 5 and q["validators"] == []
    assert [s["threshold"] for s in q["inner_sets"]] == [2] * 7
    assert [s["validators"] for s in q["inner_sets"]] == orgs
    assert len(set(links(orgs))) == 49


def test_a_window_that_outruns_its_traffic_stops_the_run():
    from benchmark import node

    assert node.from_pool(["a", "b"], 1) == "b"
    with pytest.raises(RuntimeError, match="pool_ledgers"):
        node.from_pool(["a", "b"], 2)
