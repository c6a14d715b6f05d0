"""Build and load the port's host library (``csrc/*.cpp``): its own JPEG
decoder and encoder, a PNG decoder and the threaded frame loader.

The library is compiled at first use with the host C++ compiler (``$CXX``,
else ``c++``; never ``nvcc``) into ``build/libttv_host_<hash>.so`` at the
repo root; the naming, locking and loading are ``utils/native_build``'s.
A missing compiler or a failed build raises with the compiler's output:
nothing falls back to another decoder.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from .native_build import NativeLibrary, find_compiler

FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_S = ctypes.c_char_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)

# entry point -> (restype, argtypes)
_SIGNATURES = {
    # paths, n, h, w, flip, num_threads, out, err, errlen
    "ttv_load_frames": (_I, [ctypes.POINTER(_S), _I, _I, _I, _I, _I, _P, _S, _I]),
    "ttv_load_frames_u8": (_I, [ctypes.POINTER(_S), _I, _I, _I, _I, _I, _P, _S, _I]),
    # data, n, *out, *h, *w, err, errlen
    "ttv_jpeg_decode": (_I, [_P, _L, _PP, _IP, _IP, _S, _I]),
    # pixels, h, w, c, scan_per_component, *out, err, errlen
    "ttv_jpeg_encode": (_L, [_P, _I, _I, _I, _I, _PP, _S, _I]),
    "ttv_free": (None, [_P]),
}


def _compiler() -> str:
    return find_compiler([os.environ.get("CXX") or "c++"],
                         "the host library (JPEG codec, frame loader) is built with $CXX or c++")


def _build(cxx: str, sources: list, out: Path) -> None:
    cmd = [cxx] + FLAGS + ["-o", str(out)] + [str(p) for p in sources if p.suffix == ".cpp"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"building the host library failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{(res.stdout + res.stderr)[-8000:]}")


LIB = NativeLibrary("ttv_host", Path(__file__).resolve().parent.parent / "csrc",
                    ["*.cpp", "*.h"], FLAGS, _compiler, _build, _SIGNATURES)


def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    return LIB.library()


def library_path():
    """Path of the loaded library (None before the first build/load)."""
    return LIB.path


def error_buffer():
    return ctypes.create_string_buffer(1024)


def _take(lib, ptr: ctypes.c_void_p, nbytes: int) -> bytes:
    try:
        return ctypes.string_at(ptr, nbytes)
    finally:
        lib.ttv_free(ptr)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB of JPEG bytes: ``cv2.imread``'s pixels in RGB
    order.  Raises ``ValueError`` naming ``name`` for a stream it cannot
    decode (arithmetic-coded, lossless, 12-bit, truncated, ...)."""
    lib = library()
    out, h, w, err = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int(), error_buffer()
    buf = ctypes.create_string_buffer(data, len(data))
    if lib.ttv_jpeg_decode(buf, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                           err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    px = _take(lib, out, h.value * w.value * 3)
    return np.frombuffer(px, np.uint8).reshape(h.value, w.value, 3)


def encode_jpeg(img: np.ndarray, scan_per_component: bool = False) -> bytes:
    """The JPEG bytes ``cv2.imwrite`` writes at its defaults (quality 95,
    4:2:0) for an ``[H, W, 3]`` uint8 RGB image given to it in BGR, or an
    ``[H, W]`` grey one.  ``scan_per_component`` (a test mode, for the
    decoder's non-interleaved path): the same frame with each component of
    an RGB image in a scan of its own."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[..., 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes [H, W, 3] RGB or [H, W] grey, got {img.shape}")
    lib = library()
    out, err = ctypes.c_void_p(), error_buffer()
    c = 1 if img.ndim == 2 else 3
    n = lib.ttv_jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], c,
                            int(scan_per_component), ctypes.byref(out), err, len(err))
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    return _take(lib, out, n)
