"""The port's tools: the counterparts of the repository's ``tools/`` that
run the port, on the GPU unless ``--device cpu`` is given (tests only).

    python -m stellar_core_tpu_torch.tools.catchup_bench [--entries N]
    python -m stellar_core_tpu_torch.tools.chaos_bench [--tier core4]
    python -m stellar_core_tpu_torch.tools.fuzz_repro traces/FUZZ_REPRO_*.json

Each prints JSON lines on stdout and writes a file only with ``--out``.
"""
import sys


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


def node_kw(device) -> dict:
    """``Simulation`` keywords for ``--device``: the GPU with the nodes'
    default backends (``auto``: ``cuda`` verify, ``tensor`` tallies), or
    the CPU with the host tiers (a plain-torch verify of every overlay
    batch would take seconds on the CPU)."""
    if device == "cpu":
        return {"device": "cpu", "CRYPTO_BACKEND": "cpu",
                "SCP_TALLY_BACKEND": "host"}
    return {"device": "cuda", "CRYPTO_BACKEND": "auto",
            "SCP_TALLY_BACKEND": "auto"}
