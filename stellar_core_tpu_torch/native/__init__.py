"""The port's native (C++) tier: copies of the JAX package's sources behind
the same getters.

- ``get_lib``: ``bucket_merge.cpp`` (bucket merges, bloom filters, index
  lower bounds) and ``quorum_enum.cpp`` (the quorum-intersection
  branch-and-bound), one ctypes library;
- ``get_xdrpack``: ``xdr_pack.c``, the schema-driven XDR encoder, a CPython
  extension;
- ``get_apply_kernel``: ``apply_kernel.cpp``, the GIL-free transaction
  apply kernel, a CPython extension.

Each compiles with g++ on first use into ``build/torch_native/`` at the
repository root (listed in ``.gitignore``), never next to the sources.  A
library is named by its sources' digest, so processes share one build and
an edited source builds anew; the extensions' files differ from the JAX
package's, so both packages' encoders (each with its own static schema
table) load side by side in one process.  A failed build raises with the
compiler's output: there is no quiet fall back to the Python tiers.
``build=False`` only loads a library that is already built and gives None
when there is none.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

from ..utils.lockdep import register_lock

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "quorum_enum.cpp"
MERGE_SOURCE = _DIR / "bucket_merge.cpp"
XDRPACK_SOURCE = _DIR / "xdr_pack.c"
APPLY_SOURCE = _DIR / "apply_kernel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lock = register_lock(threading.Lock(), "native.lib")
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_xdrpack_mod = None  # guarded-by: _lock
_applykernel_mod = None  # guarded-by: _lock


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the ctypes library of the current sources lives."""
    return BUILD_DIR / f"libnative-{_digest([MERGE_SOURCE, SOURCE])}.so"


def extension_path(name: str, src: Path) -> Path:
    """Where the CPython extension ``name`` built from ``src`` lives."""
    return BUILD_DIR / f"{name}-{_digest([src])}.so"


def _build(so: Path, srcs: List[Path], extra: List[str] = ()) -> None:
    """g++ into a pid-unique file, then an atomic rename: processes that
    build at once never load a torn library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", "-O2", "-shared", "-fPIC", *extra, "-o",
                          str(tmp), *map(str, srcs)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        names = ", ".join(s.name for s in srcs)
        raise RuntimeError(f"g++ failed for {names} "
                           f"(rc={res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The bucket-merge and quorum-enumeration library, built on first
    use; raises when g++ fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so, [MERGE_SOURCE, SOURCE])
        lib = ctypes.CDLL(str(so))
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        pu64 = ctypes.POINTER(ctypes.c_uint64)
        lib.bucket_merge.restype = ctypes.c_int64
        lib.bucket_merge.argtypes = [
            ctypes.c_char_p, p64, p32, p32, ctypes.c_int64,
            ctypes.c_char_p, p64, p32, p32, ctypes.c_int64,
            p32, p64, p32,
        ]
        lib.bucket_merge_stream.restype = ctypes.c_int64
        lib.bucket_merge_stream.argtypes = [
            ctypes.c_char_p, p64, p32,        # new stream/eoff/elen
            ctypes.c_char_p, p64, p32, p32,   # new keys/koff/klen/types
            ctypes.c_int64,                   # n_new
            ctypes.c_char_p, p64, p32,        # old stream/eoff/elen
            ctypes.c_char_p, p64, p32, p32,   # old keys/koff/klen/types
            ctypes.c_int64,                   # n_old
            ctypes.c_char_p,                  # out_path (NULL = no file)
            p64, p32, p32,                    # out eoff/elen/types
            pu8, p64, p32,                    # out keys/koff/klen
            pu8, p64,                         # out_hash32, out_bytes
        ]
        lib.bucket_lower_bound.restype = None
        lib.bucket_lower_bound.argtypes = [
            ctypes.c_char_p, p64, p32, ctypes.c_int64,
            ctypes.c_char_p, p64, p32, ctypes.c_int64, p64,
        ]
        lib.bloom_fill.restype = None
        lib.bloom_fill.argtypes = [
            ctypes.c_char_p, p64, p32, ctypes.c_int64, pu64, ctypes.c_int64,
        ]
        lib.bloom_check.restype = None
        lib.bloom_check.argtypes = [
            pu64, ctypes.c_int64, ctypes.c_char_p, p64, p32, ctypes.c_int64,
            p32,
        ]
        lib.quorum_enum_check.restype = ctypes.c_int64
        lib.quorum_enum_check.argtypes = [
            ctypes.c_int32,                      # n_nodes
            p32,                                 # top_thr [n]
            pu64,                                # top_mem [n*W]
            p32,                                 # inner_off [n+1]
            p32,                                 # inner_thr [total]
            pu64,                                # inner_mem [total*W]
            p32,                                 # interrupt flag (polled)
            ctypes.c_int64,                      # max_calls (0 = unlimited)
            pu64,                                # out_q1 [W]
            pu64,                                # out_q2 [W]
            p64,                                 # out_calls
        ]
        _lib = lib
        return _lib


def _extension(name: str, src: Path, build: bool):
    """Load the CPython extension ``name`` from its digest-named file,
    building it first when ``build`` (caller holds ``_lock``)."""
    so = extension_path(name, src)
    if not so.exists():
        if not build:
            return None
        _build(so, [src], ["-I", sysconfig.get_paths()["include"]])
    spec = importlib.util.spec_from_file_location(name, str(so))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_xdrpack(build: bool = True):
    """The _xdrpack extension (schema-driven XDR encoder).  With
    ``build=False`` only an already-built library is loaded (imports stay
    cheap; node start-up builds it), else None."""
    global _xdrpack_mod
    with _lock:
        if _xdrpack_mod is None:
            _xdrpack_mod = _extension("_xdrpack", XDRPACK_SOURCE, build)
        return _xdrpack_mod


def get_apply_kernel():
    """The _applykernel extension (GIL-free transaction-apply kernel),
    built on first use; raises when g++ fails."""
    global _applykernel_mod
    with _lock:
        if _applykernel_mod is None:
            _applykernel_mod = _extension("_applykernel", APPLY_SOURCE, True)
        return _applykernel_mod
