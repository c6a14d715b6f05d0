"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

All kernels live in one shared library with plain ``extern "C"`` launchers,
compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/libttv_kernels_<hash>.so`` at the repo root (one compiler process per
source, in parallel, then one link) and loaded with ``ctypes``; the naming,
locking and loading are ``utils/native_build``'s.

Nothing here runs at import time: the CPU tests import every module of the
port, and a machine without ``nvcc`` never reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from ..utils.native_build import NativeLibrary, find_compiler

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# launcher name -> argtypes (pointers and the stream as c_void_p, ints as
# c_int: ctypes would otherwise pass a pointer as a 32-bit int)
_SIGNATURES = {
    # q, k, v, o, B, S, H, D, batch stride, row stride, scale, is_bf16, stream
    "ttv_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _I, _P],
    # x, gamma, beta, y, part, rows, S, C, G, eps, silu, rows_per_block, kmax, grid,
    # resident, smem, is_bf16, stream
    "ttv_groupnorm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, w, wb, out, scratch, R, C, N, eps, is_bf16, geglu, wm (fp32:
    # the configuration), stages, grid, smem, stream
    "ttv_ln_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P],
    # leaf table, n_leaves, total_blocks, mq2, ms2, nq2, ns2, hyper (17 floats),
    # max_grid, stream
    "ttv_adam8bit_multi": [_P, _I, _I, _P, _P, _P, _P, ctypes.POINTER(_F), _I, _P],
}

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    return find_compiler(["nvcc", "/usr/local/cuda/bin/nvcc"],
                         "the Hopper kernels are built with the CUDA toolkit "
                         "(PATH or /usr/local/cuda/bin)")


def _build(nvcc: str, sources: list, out: Path) -> None:
    """One ``nvcc -c`` per ``.cu``, all started together, then one link."""
    jobs = []
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = out.with_name(f"{src.stem}.{os.getpid()}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc] + _FLAGS + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode:
            failed.append(src.name)
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
        res = subprocess.run([nvcc] + _ARCH + ["-shared", "-o", str(out)] + objs,
                             capture_output=True, text=True)
        log.append(f"== link (rc {res.returncode})\n{res.stdout}{res.stderr}")
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
    finally:
        (out.parent / "nvcc.log").write_text("\n".join(log))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


LIB = NativeLibrary(
    "ttv_kernels", Path(__file__).resolve().parent.parent / "csrc", ["*.cu", "*.cuh"], _FLAGS,
    _nvcc, _build, {name: (ctypes.c_int, argtypes) for name, argtypes in _SIGNATURES.items()})


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return LIB.library()


def library_path():
    """Path of the loaded library (None before the first build/load)."""
    return LIB.path


def launch(name: str, on, *args) -> None:
    """Call launcher ``name`` on the device of tensor ``on``, with the
    arguments and then that device's current stream: the device is made the
    thread's current one for the call, so the launcher's per-device state
    and the launch itself belong to the device that owns the tensors.  Raise
    on a nonzero ``cudaGetLastError`` (or, from 1000 up, a failed
    ``cuTensorMapEncodeTiled``: 1000 + its CUresult)."""
    import torch

    fn = getattr(library(), name)
    with torch.cuda.device(on.device):
        err = fn(*args, torch.cuda.current_stream(on.device).cuda_stream)
    if err >= 1000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed (CUresult {err - 1000})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
