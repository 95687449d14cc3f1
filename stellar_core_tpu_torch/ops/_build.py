"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel source in ``csrc/`` has a plain C entry point; ``build`` runs
``nvcc`` for ``sm_90a`` once per process, in a fresh directory under
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``, removed once the library is loaded), so that the
compiler's report (registers, spills, stack frame) always belongs to the
library in use.  Nothing here runs at import time: the first call that
needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    """A loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    seconds: float  # nvcc wall time
    log: str        # nvcc / ptxas output (registers, spills, shared memory)


_lock = threading.Lock()
_loaded: dict[str, Built] = {}  # guarded-by: _lock


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default
    /usr/local/cuda).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def build(name: str, source: str, headers: dict[str, str]) -> Built:
    """Compile ``csrc/<source>`` (with generated ``headers``, file name ->
    text) into ``lib<name>.so`` and load it, once per process.  Raises
    RuntimeError with the compiler's output when nvcc fails."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix=f"{name}-",
                                         dir=BUILD_DIR) as out_dir:
            for fname, text in headers.items():
                (Path(out_dir) / fname).write_text(text)
            so = Path(out_dir) / f"lib{name}.so"
            cmd = [nvcc(), *NVCC_FLAGS, "-I", out_dir, "-o", str(so),
                   str(CSRC / source)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} "
                                   f"(rc={res.returncode}):\n{log}")
            # the mapping outlives the file
            built = Built(ctypes.CDLL(str(so)), seconds, log)
        _loaded[name] = built
        return built
