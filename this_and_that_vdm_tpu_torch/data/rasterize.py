"""Gesture-point rasterisation, the "this"/"that" conditioning frames
(numpy-only copy of ``this_and_that_vdm_tpu/data/rasterize.py``).

For each gesture point: a 21x21 square on a white canvas at the ORIGINAL
image resolution (point 0 red ``[0,0,255]`` BGR, point 1 green
``[0,255,0]``), blurred by a 99x99 isotropic Gaussian (sigma 10, reflect-101
border), bicubic-resized to model resolution, optionally flipped, scaled to
[0, 1] and placed at ``frame_idx`` of an otherwise zero ``[F, H, W, 3]``
raster.  Channels stay BGR, as the trained GestureNet saw them.

The JAX package calls ``cv2.filter2D`` and ``cv2.resize``.  Here the
Gaussian, which is exactly ``outer(g, g)`` of its 1-D profile, runs as two
99-tap passes (each a banded matrix with the reflect-101 border folded in),
and the resize is ``data.image.resize_bicubic``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .image import image_size, resize_bicubic

POINT_COLORS_BGR = ((0, 0, 255), (0, 255, 0))  # first red, second green
DOT_RANGE = 10  # half-width of the painted square
BLUR_SIZE, BLUR_SIGMA = 99, 10.0


def _grid(kernel_size: int) -> np.ndarray:
    # ``-k // 2`` is floor division of the negated size (the reference's
    # mesh grid): for k = 99 the grid runs -49..49
    return np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)


def bivariate_gaussian(kernel_size: int, sigma: float) -> np.ndarray:
    """Isotropic 2-D Gaussian kernel on the reference's centred mesh grid."""
    ax = _grid(kernel_size)
    xx, yy = np.meshgrid(ax, ax)
    kernel = np.exp(-0.5 * (xx**2 + yy**2) / sigma**2)
    return kernel / kernel.sum()


def gaussian_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """The 1-D profile g with ``outer(g, g) == bivariate_gaussian(...)``."""
    g = np.exp(-0.5 * _grid(kernel_size) ** 2 / sigma**2)
    return g / g.sum()


def _reflect101(j: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = np.abs(j) % period
    return np.where(j >= n, period - j, j)


def _filter_matrix(n: int, taps: np.ndarray) -> np.ndarray:
    """[n, n] matrix M with ``M @ x`` = x correlated with ``taps`` (centred),
    the reflect-101 border folded in."""
    r = len(taps) // 2
    i = np.broadcast_to(np.arange(n)[:, None], (n, len(taps)))
    j = _reflect101(i + np.arange(-r, r + 1)[None, :], n)
    m = np.zeros((n, n))
    np.add.at(m, (i, j), np.broadcast_to(taps, (n, len(taps))))
    return m


def gaussian_blur(img: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, bivariate_gaussian(99, 10))`` of an ``[H, W, C]``
    image: the separable passes in float64, the result in ``img``'s dtype."""
    g = gaussian_1d(BLUR_SIZE, BLUR_SIGMA)
    h, w = img.shape[:2]
    x = np.tensordot(_filter_matrix(h, g), img.astype(np.float64), axes=(1, 0))
    x = np.tensordot(x, _filter_matrix(w, g), axes=(1, 1))  # [H, C, W]
    return np.moveaxis(x, -1, 1).astype(img.dtype)


def rasterize_gesture_points(
    points: Sequence[Tuple[int, float, float]],  # (frame_idx, x, y) original-res
    original_hw: Tuple[int, int],
    target_hw: Tuple[int, int],
    num_frames: int = 14,
    flip: bool = False,
    dilate: bool = True,
) -> np.ndarray:
    """Returns ``[F, H, W, 3]`` float32 in [0,1] (zeros except gesture frames)."""
    oh, ow = original_hw
    th, tw = target_hw
    condition = np.zeros((num_frames, th, tw, 3), np.float32)
    for idx, (frame_idx, x, y) in enumerate(points):
        col, row = int(float(x)), int(float(y))
        canvas = np.full((oh, ow, 3), 255.0, np.float32)
        r0, r1 = max(row - DOT_RANGE, 0), min(row + DOT_RANGE + 1, oh)
        c0, c1 = max(col - DOT_RANGE, 0), min(col + DOT_RANGE + 1, ow)
        canvas[r0:r1, c0:c1] = POINT_COLORS_BGR[min(idx, 1)]
        if dilate:
            canvas = gaussian_blur(canvas)
        canvas = resize_bicubic(canvas, th, tw)
        if flip:
            canvas = np.fliplr(canvas)
        condition[int(frame_idx)] = canvas / 255.0
    return condition


def read_gesture_file(path: str) -> List[Tuple[int, float, float]]:
    """Parse ``data.txt`` lines ``frame_idx x y`` (reference column order:
    frame_idx, horizontal, vertical)."""
    points = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            frame_idx, x, y = line.split(" ")
            points.append((int(frame_idx), float(x), float(y)))
    return points


def load_condition(instance_dir: str, target_hw: Tuple[int, int], num_frames: int = 14,
                   flip: bool = False, dilate: bool = True):
    """(condition [F,H,W,3] in [0,1], motion_bucket_id, frame indices, coords
    (vertical, horizontal)) of an instance folder; only the size of
    ``im_0.jpg`` is read, from its header."""
    points = read_gesture_file(os.path.join(instance_dir, "data.txt"))
    oh, ow = image_size(os.path.join(instance_dir, "im_0.jpg"))
    cond = rasterize_gesture_points(points, (oh, ow), target_hw, num_frames, flip, dilate)
    indices = [p[0] for p in points]
    coords = [(p[2], p[1]) for p in points]
    return cond, 200, indices, coords
