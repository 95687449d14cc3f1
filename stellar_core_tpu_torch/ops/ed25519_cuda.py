"""Batched ed25519 verify through the hand-written Hopper kernel
``csrc/ed25519_verify.cu`` — the port of the JAX package's Pallas kernel
(``ops/ed25519_pallas.py::_verify_kernel`` and its wrapper's prologue).

``verify_batch`` dispatches on where its inputs lie: CPU tensors go to the
plain torch version (``ops/ed25519_kernel.verify_batch``); CUDA tensors
launch the kernel, or raise.  There is no fallback from the kernel to the
plain version: a failed build or launch is an exception.

The kernel's constants are generated here, at build time, from the port's
spec copy (``crypto/ed25519_ref.py``) and SHA-512 module, into the header
``ed25519_consts.h``.
"""
from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch

from ..crypto import ed25519_ref as ref
from ..utils.device import default_device
from . import _build
from . import ed25519_kernel as plain
from .sha512 import IV64, K64

KERNEL = "ed25519_verify"
SOURCE = "ed25519_verify.cu"

# Launches of the kernel since the last reset: incremented where the
# kernel is launched and nowhere else.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# constants header (radix 2^32 field elements, see the .cu file)
# ---------------------------------------------------------------------------

def fe8(v: int) -> list[int]:
    """Python int (mod p) -> 8 canonical little-endian 32-bit words."""
    return _limbs32(v % ref.P, 8)


def _b_table() -> list[list[list[int]]]:
    """[1..8]*B in affine niels form: (y + x, y - x, 2 d x y)."""
    rows, pt = [], ref.IDENT
    for _ in range(8):
        pt = ref.point_add(pt, ref.to_extended(ref.B))
        x, y, z, _t = pt
        zi = pow(z, ref.P - 2, ref.P)
        xa, ya = x * zi % ref.P, y * zi % ref.P
        rows.append([fe8(ya + xa), fe8(ya - xa), fe8(2 * ref.D * xa * ya)])
    return rows


def _limbs32(v: int, n: int) -> list[int]:
    out = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]
    assert v >> (32 * n) == 0
    return out


def _arr(ctype: str, name: str, dims: str, body) -> str:
    def fmt(x):
        if isinstance(x, (list, tuple)):
            return "{" + ", ".join(fmt(e) for e in x) + "}"
        return f"{x:#x}u" if isinstance(x, int) else str(x)
    return f"{ctype} {name}{dims} = {fmt(body)};\n"


def consts_header() -> str:
    """Text of ``ed25519_consts.h``: every constant the kernel reads."""
    so = [_limbs32(int.from_bytes(e, "little"), 8)
          for e in ref.SMALL_ORDER_ENCODINGS]
    return "".join([
        "// Generated by stellar_core_tpu_torch/ops/ed25519_cuda.py from the\n"
        "// port's ed25519 spec copy; do not edit.\n#pragma once\n",
        f"#define ED_N_SMALL_ORDER {len(so)}\n",
        _arr("__constant__ uint32_t", "ED_D", "[8]", fe8(ref.D)),
        _arr("__constant__ uint32_t", "ED_D2", "[8]", fe8(2 * ref.D)),
        _arr("__constant__ uint32_t", "ED_SQRTM1", "[8]", fe8(ref.SQRT_M1)),
        _arr("__device__ const uint32_t", "ED_BTAB", "[8][3][8]", _b_table()),
        _arr("__constant__ uint32_t", "ED_SMALL_ORDER", f"[{len(so)}][8]", so),
        _arr("__constant__ uint32_t", "ED_L_WORDS", "[8]", _limbs32(ref.L, 8)),
        _arr("__constant__ uint32_t", "ED_POW8", "[64][8]",
             [_limbs32(pow(2, 8 * i, ref.L), 8) for i in range(64)]),
        _arr("__constant__ uint32_t", "ED_LSHIFT", "[14][9]",
             [_limbs32(ref.L << k, 9) for k in range(14)]),
        _arr("__constant__ uint64_t", "SHA512_K", "[80]",
             [f"{k}ULL" for k in K64]),
        _arr("__constant__ uint64_t", "SHA512_IV", "[8]",
             [f"{v}ULL" for v in IV64]),
    ])


@functools.cache
def build() -> _build.Built:
    """Build and load the kernel library, once per process."""
    built = _build.build(KERNEL, SOURCE, {"ed25519_consts.h": consts_header()})
    for fn in (built.lib.ed25519_verify_launch, built.lib.ed25519_dsm_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (built.lib.ed25519_verify_threads,
               built.lib.ed25519_verify_blocks_per_sm):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    return built


def ptxas_stats(log: str, function: str = "ed25519_verify_kernel") -> dict:
    """Registers, stack frame and spill bytes of ``function`` from an
    ``nvcc -Xptxas -v`` log."""
    props, regs, cur, entry = {}, {}, None, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            entry = m[1]
        elif m := re.search(r"Function properties for (\S+)", ln):
            cur = m[1]
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", ln):
            props[cur] = tuple(int(x) for x in m.groups())
        elif m := re.search(r"Used (\d+) registers", ln):
            regs[entry] = int(m[1])
    name = next(k for k in props if function in k)
    stack, stores, loads = props[name]
    return {"registers": regs[name], "stack_frame_bytes": stack,
            "spill_stores": stores, "spill_loads": loads}


def launch_shape(rows: int) -> dict:
    """Threads a block and resident blocks (and warps) per SM of the verify
    kernel for a launch of ``rows`` rows."""
    lib = build().lib
    threads, blocks = (lib.ed25519_verify_threads(rows),
                       lib.ed25519_verify_blocks_per_sm(rows))
    if blocks < 0:
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor failed")
    return {"threads_per_block": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x, dtype=np.uint8, order="C"),
                           device=default_device(device))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows as 16-byte vectors: copy a view whose base is
    not 16-byte aligned (a fresh allocation is)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def verify_batch(pubkeys, sigs, msgs, device=None) -> torch.Tensor:
    """Batched ed25519 verify: (N,32) x (N,64) x (N,32) uint8 -> (N,) bool.

    Tensors stay where they are; numpy inputs are placed on ``device``
    (default: the GPU, raising when there is none).  CPU tensors run the
    plain torch version; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise."""
    pk, sg, mg = (_as_tensor(x, device) for x in (pubkeys, sigs, msgs))
    dev = pk.device
    if sg.device != dev or mg.device != dev:
        raise ValueError("pubkeys, sigs and msgs must be on one device")
    if dev.type == "cpu":
        return plain.verify_batch(pk, sg, mg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = pk.shape[0]
    for t, width, label in ((pk, 32, "pubkeys"), (sg, 64, "sigs"),
                            (mg, 32, "msgs")):
        if t.dtype != torch.uint8 or t.shape != (n, width):
            raise ValueError(f"{label} must be uint8 ({n}, {width}), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    pk, sg, mg = _aligned(pk), _aligned(sg), _aligned(mg)
    fn = build().lib.ed25519_verify_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(pk.data_ptr(), sg.data_ptr(), mg.data_ptr(), out.data_ptr(), n,
            stream)
    if rc != 0:
        raise RuntimeError(f"ed25519_verify launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def double_scalar(a: torch.Tensor, s: torch.Tensor, h: torch.Tensor
                  ) -> torch.Tensor:
    """Test-only entry: the encodings of [s]B + [h](-A), (N,32) uint8, for
    CUDA uint8 tensors A, s, h of shape (N,32) (A a valid encoding, s and h
    little-endian below 2^254), through the verify kernel's own device
    functions.  Not on the main path, and not counted in ``launches``."""
    n = a.shape[0]
    for t in (a, s, h):
        if (t.device.type != "cuda" or t.dtype != torch.uint8
                or t.shape != (n, 32) or not t.is_contiguous()):
            raise ValueError("double_scalar takes contiguous CUDA uint8 "
                             "(N, 32) tensors")
    out = torch.empty((n, 32), dtype=torch.uint8, device=a.device)
    a, s, h = _aligned(a), _aligned(s), _aligned(h)
    rc = build().lib.ed25519_dsm_launch(
        a.data_ptr(), s.data_ptr(), h.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ed25519_dsm launch failed: cudaError {rc}")
    return out
