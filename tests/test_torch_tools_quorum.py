"""``tools/quorum_tier_bench`` and ``tools/multichip_bench`` of the port
against the repository's ``tools/quorum_tier_bench.py`` and
``tools/multichip_bench.py`` on the CPU (``--device cpu``: the device
tier and the data-parallel split on CPU tensors).

Every tier scans to its verdict.  The JAX tool's device tier is XLA on
the host CPU; at 24 nodes it takes ~37 s to its verdict on the CPU, so
there it is not run and the port's device tier is held against the JAX
tool's native and numpy tiers.

Tolerance: exact (``ok``, ``scanned``, ``aborted`` per tier; verdicts).
"""
import pytest

from stellar_core_tpu_torch.tools import quorum_tier_bench as QTB

from .test_torch_tools import run_tool

# size -> (the verdict, the JAX tool's tiers run there)
VERDICTS = {16: ((True, 4003, False),
                 ("native", "python_numpy", "python_device")),
            24: ((True, 155039, False), ("native", "python_numpy"))}
JAX_TIERS = {"native": dict(use_native=True, use_device=False),
             "python_numpy": dict(use_native=False, use_device=False),
             "python_device": dict(use_native=False, use_device=True)}


@pytest.fixture(autouse=True)
def jax_host_tiers(monkeypatch):
    """The JAX checker's device tier never waits on a device probe."""
    from stellar_core_tpu.utils import device as jax_device

    monkeypatch.setattr(jax_device, "device_available",
                        lambda timeout=10.0: False)


def jax_tier_row(n: int, labels) -> dict:
    """The JAX tool's tiers ``labels`` (``tools/quorum_tier_bench.py``:
    ``build_qmap`` and its tier keywords), each to its verdict."""
    from stellar_core_tpu.herder.quorum_intersection import \
        check_quorum_intersection
    from tools.quorum_tier_bench import build_qmap

    qmap = build_qmap(n)
    row = {}
    for label in labels:
        res = check_quorum_intersection(qmap, max_seconds=120,
                                        **JAX_TIERS[label])
        row[label] = (res.ok, res.scanned, bool(res.aborted))
    return row


@pytest.mark.parametrize("n", sorted(VERDICTS))
def test_tier_verdicts_and_scans_equal_the_jax_tool(n):
    verdict, labels = VERDICTS[n]
    want = jax_tier_row(n, labels)
    assert want == dict.fromkeys(labels, verdict)
    got = QTB.tier_row(n, ["cpu"])
    cells = {"native": got["native"], "python_numpy": got["python_numpy"],
             "python_device": got["python_device"]["cpu"]}
    for label, cell in cells.items():
        assert (cell["ok"], cell["scanned"], cell["aborted"]) == \
            want.get(label, want["native"]), label
    assert got["python_device"]["cpu"]["device"] == "cpu"


def test_qmaps_equal_the_jax_tools():
    from stellar_core_tpu.xdr import types as JT
    from stellar_core_tpu_torch.xdr import types as T
    from tools.quorum_tier_bench import build_qmap

    mine, theirs = QTB.build_qmap(24), build_qmap(24)
    assert list(mine) == list(theirs)
    assert [T.SCPQuorumSet.encode(q) for q in mine.values()] == \
        [JT.SCPQuorumSet.encode(q) for q in theirs.values()]


def test_quorum_tool_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "out" / "quorum.json"
    out.parent.mkdir()
    rc, lines, files = run_tool(
        "quorum_tier_bench", ["16", "--out", str(out)], tmp_path, capsys)
    assert rc == 0 and files == ["out"]
    row, doc = lines
    assert row["scc_size"] == 16
    for cell in (row["native"], row["python_numpy"],
                 row["python_device"]["cpu"]):
        assert (cell["ok"], cell["scanned"]) == (True, 4003)
    assert doc["rows"] == [row] and doc["card"] is None
    assert doc == __import__("json").loads(out.read_text())


def test_multichip_tool_on_the_cpu(tmp_path, capsys):
    """The cpu arm over 2 CPU chunks and over one, at 8 signatures; every
    verdict true (``bench_sharded`` asserts it) and the tally shapes."""
    rc, lines, files = run_tool(
        "multichip_bench", ["--cpu-sigs", "8", "--cpu-chunks", "2"],
        tmp_path, capsys)
    assert rc == 0 and files == []
    arm, doc = lines
    assert doc["arms"] == [arm]
    assert arm["backend"] == "cpu" and arm["ran_on"] == ["cpu", "cpu"]
    assert arm["sharded"]["n_devices"] == 2
    assert arm["one_device_comparison"]["n_devices"] == 1
    assert arm["sharded"]["n_signatures"] == \
        arm["one_device_comparison"]["n_signatures"] == 8
    assert arm["crypto.verify.kernel-launches"] == 0
