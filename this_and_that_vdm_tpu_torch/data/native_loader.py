"""ctypes bindings of the port's native frame loader (``csrc/ttv_loader.cpp``,
the counterpart of the JAX package's ``native/ttv_loader.cpp``).

One call decodes a batch of frames (PNG or JPEG by signature, through the
port's own codecs, ``cv2.imread``'s pixels), resizes each bicubic on uint8
bit for bit as ``data.image.resize_bicubic`` does, optionally flips it and
writes float32 in [-1, 1] (``x / 127.5 - 1``) or uint8, on a pool of C++
threads.  ctypes releases the GIL during the call, so the ``PrefetchLoader``
threads decode side by side.  The library is built at first use
(``utils.host_native``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from ..utils import host_native


def get_lib() -> ctypes.CDLL:
    """The host library (built on first call)."""
    return host_native.library()


def available() -> bool:
    """True once the library is built; a failed build raises instead."""
    return get_lib() is not None


def _load(entry: str, paths: Sequence[str], hw, flip: bool, num_threads: int,
          dtype) -> np.ndarray:
    h, w = (int(x) for x in hw)
    if h < 1 or w < 1:
        raise ValueError(f"load_frames_native: bad output size {hw}")
    n = len(paths)
    out = np.empty((n, h, w, 3), dtype)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    err = host_native.error_buffer()
    rc = getattr(get_lib(), entry)(arr, n, h, w, int(flip), num_threads, out.ctypes.data,
                                   err, len(err))
    if rc != 0:  # 1 + the first failing index: a frame that cannot be read raises
        path = paths[rc - 1]
        msg = err.value.decode(errors="replace")
        raise (ValueError if os.path.exists(path) else FileNotFoundError)(msg)
    return out


def load_frames_native(paths: Sequence[str], hw, flip: bool = False,
                       num_threads: int = 8) -> np.ndarray:
    """``[N, H, W, 3]`` float32 in [-1, 1] of the frames at ``paths``."""
    return _load("ttv_load_frames", paths, hw, flip, num_threads, np.float32)


def load_frames_native_u8(paths: Sequence[str], hw, flip: bool = False,
                          num_threads: int = 8) -> np.ndarray:
    """``[N, H, W, 3]`` uint8 RGB of the frames at ``paths``."""
    return _load("ttv_load_frames_u8", paths, hw, flip, num_threads, np.uint8)
