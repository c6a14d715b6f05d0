"""cv2's bicubic resize (``INTER_CUBIC``) in numpy, and an image's size read
from its file header.

The resize follows ``cv2.resize``: half-pixel centres (source coordinate
``(d + 0.5) * in / out - 0.5``), Keys' cubic with a = -0.75, the four taps
clamped to the edge.  Coordinates, weights and sums are float64, as in the
IPP routine that ``cv2.resize`` calls on x86 (within 6.1e-5 of it on a
0-255 float canvas, and the same uint8 levels bar a few pixels of random
noise); a uint8 image is rounded to the nearest level.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _cubic_taps(n_in: int, n_out: int):
    """(source indices [n_out, 4], weights [n_out, 4]) of one axis."""
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx)
    x, a = fx - sx, -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, 1 - c0 - c1 - c2], axis=1)


def _taps_sum(img, idx, w, axis):
    """sum_k img[idx[:, k]] * w[:, k] along ``axis``."""
    shape = [1] * img.ndim
    shape[axis] = -1
    return sum(np.take(img, idx[:, k], axis=axis) * w[:, k].reshape(shape) for k in range(4))


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)`` of
    an ``[H, W]`` or ``[H, W, C]`` image; uint8 stays uint8, anything else
    comes back float32."""
    ri, rw = _cubic_taps(img.shape[0], height)
    ci, cw = _cubic_taps(img.shape[1], width)
    out = _taps_sum(_taps_sum(img.astype(np.float64), ci, cw, 1), ri, rw, 0)
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file, from its header (the image is
    not decoded).  The file's signature decides the format, not its name."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            b = f.read(1)
            if not b:
                break
            if b != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":  # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m == 0xD8 or m == 0x01 or 0xD0 <= m <= 0xD7:
                continue  # no length field
            (length,) = struct.unpack(">H", f.read(2))
            if m in _JPEG_SOF:
                _, h, w = struct.unpack(">BHH", f.read(5))
                return h, w
            f.seek(length - 2, 1)
    raise ValueError(f"{path}: no JPEG frame header found")
