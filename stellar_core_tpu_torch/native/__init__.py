"""The port's native (C++) tier: the quorum-intersection branch-and-bound
(``quorum_enum.cpp``, a copy of the JAX package's source) behind ctypes.

``get_lib`` compiles it with g++ on first use into ``build/torch_native/``
at the repository root (listed in ``.gitignore``), never next to the
sources.  The library is named by the source's digest, so processes share
one build and an edited source builds anew.  A failed build raises with the
compiler's output: there is no quiet fall back to the Python tiers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..utils.lockdep import register_lock

SOURCE = Path(__file__).resolve().parent / "quorum_enum.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lock = register_lock(threading.Lock(), "native.lib")
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock


def library_path() -> Path:
    """Where the library of the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libquorum_enum-{digest}.so"


def _build(so: Path) -> None:
    """g++ into a pid-unique file, then an atomic rename: processes that
    build at once never load a torn library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} "
                           f"(rc={res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use; raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.quorum_enum_check.restype = ctypes.c_int64
        lib.quorum_enum_check.argtypes = [
            ctypes.c_int32,                      # n_nodes
            ctypes.POINTER(ctypes.c_int32),      # top_thr [n]
            ctypes.POINTER(ctypes.c_uint64),     # top_mem [n*W]
            ctypes.POINTER(ctypes.c_int32),      # inner_off [n+1]
            ctypes.POINTER(ctypes.c_int32),      # inner_thr [total]
            ctypes.POINTER(ctypes.c_uint64),     # inner_mem [total*W]
            ctypes.POINTER(ctypes.c_int32),      # interrupt flag (polled)
            ctypes.c_int64,                      # max_calls (0 = unlimited)
            ctypes.POINTER(ctypes.c_uint64),     # out_q1 [W]
            ctypes.POINTER(ctypes.c_uint64),     # out_q2 [W]
            ctypes.POINTER(ctypes.c_int64),      # out_calls
        ]
        _lib = lib
        return _lib
