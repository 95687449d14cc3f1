"""The port's tools: the counterparts of the repository's ``tools/`` that
run the port, on the GPU unless ``--device cpu`` is given (tests only).

    python -m stellar_core_tpu_torch.tools.catchup_bench [--entries N]
    python -m stellar_core_tpu_torch.tools.chaos_bench [--tier core4]
    python -m stellar_core_tpu_torch.tools.fuzz_repro traces/FUZZ_REPRO_*.json
    python -m stellar_core_tpu_torch.tools.quorum_tier_bench [16 24 ...]
    python -m stellar_core_tpu_torch.tools.multichip_bench
    python -m stellar_core_tpu_torch.tools.parallel_apply_bench [--shapes ..]
    python -m stellar_core_tpu_torch.tools.pipeline_bench
    python -m stellar_core_tpu_torch.tools.soak_bench [--smoke]
    python -m stellar_core_tpu_torch.tools.scp_forensics_bench [--smoke]
    python -m stellar_core_tpu_torch.tools.fuzz_bench [--smoke]
    python -m stellar_core_tpu_torch.tools.bucket_scale_bench [N [PER]]
    python -m stellar_core_tpu_torch.tools.read_bench [N [PER [READS]]]
    python -m stellar_core_tpu_torch.tools.chaos_bench --netobs [--tier ..]
    python -m stellar_core_tpu_torch.tools.capture_loop [--n N]
    python -m stellar_core_tpu_torch.tools.verify_green [--lint-only]
    python -m stellar_core_tpu_torch.tools.lint [--strict|--json|--changed]
    python -m stellar_core_tpu_torch.tools.trace_view <trace.json> [..]
    python -m stellar_core_tpu_torch.tools.fleet_scrape --nodes HOST:PORT,..

Each prints JSON lines on stdout, the result last, and writes a file only
with ``--out``.  ``lint`` (detlint over the port's package),
``trace_view`` and ``fleet_scrape`` run nothing on a device: they are the
repository's tools pointed at the port, and take no ``--device``.  A tool whose workload runs on a node runs it once a
backend (``BACKENDS``): on the GPU a ``cuda`` node (the verify kernel, the
tallies on the card) and a ``cpu`` node (host verifies and tallies) on
the same host, in turns (``turns``) where the tool measures more than
once, each row with the verify kernel's launches in the arm and the
card's name and power limit.
"""
import contextlib
import functools
import json
import subprocess
import sys
import tempfile

# The node keywords of each backend arm: a ``cuda`` node verifies every
# close's signature batch with the kernel and tallies on the card; a
# ``cpu`` node runs the host tiers and needs no device.
BACKENDS = {
    "cuda": {"device": "cuda", "CRYPTO_BACKEND": "cuda",
             "SCP_TALLY_BACKEND": "tensor"},
    "cpu": {"device": "cpu", "CRYPTO_BACKEND": "cpu",
            "SCP_TALLY_BACKEND": "host"},
}
LAUNCHES = "crypto.verify.kernel-launches"


def no_gpu(prog: str) -> bool:
    """True, with a line on stderr, when no CUDA device is present: a tool
    run without ``--device`` then exits non-zero instead of running on the
    CPU."""
    import torch

    if torch.cuda.is_available():
        return False
    print(f"{prog}: no CUDA device is available (--device cpu runs the "
          f"port on the CPU, for tests)", file=sys.stderr)
    return True


def add_device_arg(ap) -> None:
    """``--device cpu``: every node on the host tiers, for tests."""
    ap.add_argument("--device", choices=["cpu"], default=None,
                    help="run every node on the CPU with the host tiers "
                         "(tests); default: the GPU with the device tiers")


def add_backend_arg(ap) -> None:
    """``--device cpu`` and ``--backend cuda|cpu`` (repeatable)."""
    add_device_arg(ap)
    ap.add_argument("--backend", choices=sorted(BACKENDS), action="append",
                    help="run only this backend's arm (repeatable; "
                         "default cuda, then cpu on the same host; "
                         "cpu alone with --device cpu)")


def backends(ap, args) -> list:
    """The backend arms ``args`` ask for, in run order."""
    if args.device == "cpu":
        if args.backend and "cuda" in args.backend:
            ap.error("--device cpu runs the host tiers: no cuda arm")
        return ["cpu"]
    return list(dict.fromkeys(args.backend or ["cuda", "cpu"]))


def node_kw(device) -> dict:
    """``Simulation`` keywords for ``--device``: the GPU with the nodes'
    default backends (``auto``: ``cuda`` verify, ``tensor`` tallies), or
    the CPU with the host tiers (a plain-torch verify of every overlay
    batch would take seconds on the CPU)."""
    if device == "cpu":
        return dict(BACKENDS["cpu"])
    return {"device": "cuda", "CRYPTO_BACKEND": "auto",
            "SCP_TALLY_BACKEND": "auto"}


def standalone_app(backend: str, **config_kw):
    """A started standalone node built from ``test_config`` (manual close,
    in-memory database, the virtual clock) on ``backend``'s device and
    tiers; ``config_kw`` are further settings.  ``test_config`` alone pins
    the host tiers."""
    from ..main import Application, test_config
    from ..utils.clock import ClockMode, VirtualClock

    kw = dict(BACKENDS[backend])
    device = kw.pop("device")
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME),
                      test_config(**kw, **config_kw), device=device)
    app.start()
    return app


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (None without a
    GPU; the name alone, marked so, where nvidia-smi is missing)."""
    import torch

    if not torch.cuda.is_available():
        return None
    return _card_line()


@functools.cache
def _card_line() -> str:
    import torch

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def kernel_launches() -> int:
    """The verify kernel's launches in this process so far."""
    from ..ops import ed25519_cuda

    return ed25519_cuda.launches


def arm_row(backend: str) -> dict:
    """A backend arm's row: its backends, device and card, and the verify
    kernel's launches in the arm (0 until ``counting`` adds them)."""
    kw = BACKENDS[backend]
    return {"backend": backend, "device": kw["device"],
            "CRYPTO_BACKEND": kw["CRYPTO_BACKEND"],
            "SCP_TALLY_BACKEND": kw["SCP_TALLY_BACKEND"], "card": card(),
            LAUNCHES: 0}


@contextlib.contextmanager
def counting(row: dict):
    """Adds the verify kernel's launches inside the block to ``row``'s."""
    import torch

    before = kernel_launches()
    yield row
    if row["backend"] == "cuda":
        torch.cuda.synchronize()
    row[LAUNCHES] += kernel_launches() - before


def idle_note(row: dict) -> None:
    """A ``cuda`` arm that launched the kernel no time says so."""
    if row["backend"] == "cuda" and not row[LAUNCHES]:
        row["note"] = "this cuda arm launched the verify kernel no time"


@contextlib.contextmanager
def arm(backend: str):
    """One backend arm's row (``arm_row``), the launches of the block
    counted into it."""
    row = arm_row(backend)
    with counting(row):
        yield row
    idle_note(row)


def turns(arms, i: int) -> list:
    """The backend arms in the order of turn ``i``: as given on even
    turns, reversed on odd ones.  Measurements made in turns run the
    backends A B B A, so a drift of the host over the run falls on every
    backend alike."""
    return list(arms) if i % 2 == 0 else list(reversed(arms))


def work_dir(tool: str):
    """A temporary directory for one run of ``tool``: its nodes' files
    and slow-close traces, removed at the end."""
    return tempfile.TemporaryDirectory(prefix=f"{tool}-")


def emit(line: dict) -> None:
    print(json.dumps(line, sort_keys=True, default=str), flush=True)


def write_out(path, doc: dict) -> None:
    """``--out``: the whole document, when a path was given."""
    if path:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
