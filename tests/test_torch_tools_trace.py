"""The port's ``tools/trace_view`` (a copy) and ``tools/fleet_scrape`` (a
seam: its JSONL goes to stdout unless ``--out`` is given) against the
repository's tools, on the CPU:

- ``trace_view`` renders the committed ``FORENSICS_induced_fork_seed14.json``
  (``--slots``), a committed slow-close trace and a netobs observatory
  summary (``--propagation``) to the same text as ``tools/trace_view.py``;
  its ``main`` prints that text;
- ``tests/test_tracing.py::test_trace_view_renders_persisted_trace`` runs on
  the port (a port node's persisted slow-close trace);
- the six cases of ``tests/test_observatory.py`` run on the port, as the
  very code of that file with the package's dotted name written the
  port's, ``fleet_scrape`` the port's, and the executed module's ``core``
  pinned to ``device="cpu"`` and the host tiers;
- ``fleet_scrape.run`` without ``out_path`` writes its lines to stdout.

Every case runs from the test's own directory: a network of the
observatory cases writes its slow-close traces into the cwd.

Tolerance: exact (rendered text, summaries, fingerprints).
"""
import functools
import json
from pathlib import Path

import pytest

from stellar_core_tpu_torch.simulation import simulation as port_sim
from stellar_core_tpu_torch.tools import fleet_scrape, trace_view

from .test_torch_golden import TESTS, _port_tests, port_module

REPO = TESTS.parent
HOST = {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}

_OBS = port_module("test_observatory")
_OBS.core = functools.partial(port_sim.core, device="cpu", **HOST)
globals().update(_port_tests(_OBS))

_TRACING = port_module("test_tracing")
slow_close = _TRACING.slow_close   # the module-scoped fixture, on the port


@pytest.fixture(autouse=True)
def traces_in_tmp_path(tmp_path, monkeypatch):
    """A node's slow-close traces go to ``traces`` in the cwd by default:
    every network this file builds writes them under the test's own
    directory, never the checkout."""
    monkeypatch.chdir(tmp_path)


def test_observatory_cases_run_on_the_port():
    text = (TESTS / "test_observatory.py").read_text()
    names = set(_port_tests(_OBS))
    assert len(names) == text.count("\ndef test_") == 6
    assert names <= set(globals())
    names = _OBS.test_fleet_scrape_socket_free.__code__.co_names
    assert "stellar_core_tpu_torch.tools" in names and "tools" not in names
    sim = _OBS.core(2)
    assert sim.device == "cpu"
    assert all((app.config.CRYPTO_BACKEND, app.config.SCP_TALLY_BACKEND) ==
               ("cpu", "host") for app in sim.nodes.values())


def test_trace_view_renders_persisted_trace_on_the_port(slow_close):
    app, _, _ = slow_close
    assert type(app).__module__ == "stellar_core_tpu_torch.main.application"
    _TRACING.test_trace_view_renders_persisted_trace(slow_close)


def _committed_trace() -> Path:
    return sorted((REPO / "traces").glob("slow-close-*.trace.json"))[0]


@pytest.mark.parametrize("kind", ["slots", "trace"])
def test_trace_view_renders_like_the_jax_tool(kind):
    from tools import trace_view as jax_view

    if kind == "slots":
        doc = json.loads((REPO / "FORENSICS_induced_fork_seed14.json")
                         .read_text())
        got, want = (trace_view.render_slots(doc),
                     jax_view.render_slots(doc))
        assert "first divergence" in got.lower() or "slot" in got
    else:
        doc = json.loads(_committed_trace().read_text())
        got, want = trace_view.render(doc), jax_view.render(doc)
        assert "top 10 spans by self time" in got
    assert got == want and got


def test_trace_view_renders_a_netobs_summary_like_the_jax_tool():
    """The port's netobs observatory summary (core-4, ``cpu`` arm) through
    both renderers, and through the port's ``main`` from a file."""
    from tools import trace_view as jax_view

    from stellar_core_tpu_torch.tools import BACKENDS
    from stellar_core_tpu_torch.tools.chaos_bench import netobs_run

    obs = netobs_run("core4", 11, True, **BACKENDS["cpu"])["observatory"]
    got = trace_view.render_propagation({"observatory": obs})
    assert got == jax_view.render_propagation({"observatory": obs})
    assert got.startswith("4 nodes,") and "time_to_90pct" in got


def test_trace_view_main_prints_the_rendering(tmp_path, capsys, monkeypatch):
    path = _committed_trace()
    monkeypatch.setattr("sys.argv", ["trace_view", str(path), "--top", "5"])
    assert trace_view.main() == 0
    out = capsys.readouterr().out
    assert out == trace_view.render(json.loads(path.read_text()),
                                     top=5) + "\n"
    monkeypatch.setattr("sys.argv", ["trace_view", str(tmp_path / "nope")])
    assert trace_view.main() == 2


def test_fleet_scrape_writes_to_stdout_without_out(capsys, tmp_path):
    def fetch(base, path, timeout):
        if path == "info":
            return {"info": {"ledger": {"num": 7}}}
        if path == "metrics":
            return {"metrics": {"overlay.flood.unique": {"count": 3}}}
        raise KeyError(path)

    summary = fleet_scrape.run(["n1:1", "n2:2"], rounds=2, interval=0.0,
                               fetch=fetch, sleep=lambda s: None,
                               now=lambda: 5.0)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2 * 2 + 1 and lines[-1] == {"summary": summary}
    assert summary["fleet"]["n_reachable"] == 2
    assert summary["fleet"]["ledger_spread"] == 0
    assert not list(tmp_path.iterdir())


def test_fleet_scrape_main_exits_by_reachability(capsys, monkeypatch,
                                                 tmp_path):
    """``main`` without ``--out`` leaves no file; a node that does not
    answer makes it exit 1, as the repository's tool does."""
    def refused(base, path, timeout):
        raise OSError("refused")

    real = fleet_scrape.run
    monkeypatch.setattr(fleet_scrape, "run", lambda *a, **kw: real(
        *a, fetch=refused, sleep=lambda s: None, now=lambda: 0.0, **kw))
    assert fleet_scrape.main(["--nodes", "127.0.0.1:1", "--rounds", "1"]) \
        == 1
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[0])["error"].startswith("OSError")
    assert not list(tmp_path.iterdir())
