"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

All kernels live in one shared library with plain ``extern "C"`` launchers,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/`` at the repo
root (one compiler process per source, in parallel, then one link) and
loaded with ``ctypes``.  The library name carries a hash of the
sources, so an edited kernel is rebuilt and a stale one is never loaded.

Nothing here runs at import time: the CPU tests import every module of the
port, and a machine without ``nvcc`` never reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build"

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
    # x, gamma, beta, w, wb, out, scratch, R, C, N, eps, is_bf16, wm (fp32: the
    # configuration), stages, grid, smem, stream
    "ttv_ln_matmul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # leaf table, n_leaves, total_blocks, mq2, ms2, nq2, ns2, hyper (17 floats),
    # max_grid, stream
    "ttv_adam8bit_multi": [_P, _I, _I, _P, _P, _P, _P, ctypes.POINTER(_F), _I, _P],
}

_lock = threading.Lock()
_lib = None
_lib_path = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels are built with the "
                       "CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _build(target: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    flags = arch + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = target.parent / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [_nvcc()] + flags + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log)[-8000:])
        tmp = target.with_suffix(f".{tag}")
        res = subprocess.run([_nvcc()] + arch + ["-shared", "-o", str(tmp)] + objs,
                             capture_output=True, text=True)
        log.append(f"== link (rc {res.returncode})\n{res.stdout}{res.stderr}")
        if res.returncode:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    finally:
        (target.parent / "nvcc.log").write_text("\n".join(log))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def library():
    """The loaded kernel library, built on first call."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        target = _BUILD / f"libttv_kernels_{_digest()}.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib, _lib_path = lib, target
        return lib


def library_path():
    """Path of the loaded library (None before the first build/load)."""
    return _lib_path


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise on a nonzero ``cudaGetLastError`` (or,
    from 1000 up, a failed ``cuTensorMapEncodeTiled``: 1000 + its CUresult)."""
    err = getattr(library(), name)(*args)
    if err >= 1000:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed (CUresult {err - 1000})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
