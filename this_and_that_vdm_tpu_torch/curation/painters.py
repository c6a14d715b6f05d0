"""Mask, point and contour overlays of curation visualisation, and the
optical-flow colour wheel (counterpart of ``curation/painters.py``), in
numpy alone: the card's machine has no cv2.

Reference: track_anything_code/tools/painter.py:106-160 and
utils/optical_flow_utils.py.  Two drawing routines of cv2 are written out:

  * ``filled_circle``: ``cv2.circle(..., thickness=-1)`` with the default
    8-connected line, which runs cv2's integer midpoint loop (drawing.cpp
    ``Circle``), so the disc is the same pixel for pixel;
  * ``mask_contour``: ``findContours(RETR_EXTERNAL)`` + ``drawContours``
    as the outer border pixels of each component (mask pixels with a
    4-neighbour in the background that reaches the image's edge) dilated by
    cv2's own disc.  At the painters' width 3 (and at 1, 4 and 5) the band
    equals cv2's on the test masks: 0 pixels differ (tests/
    test_torch_tracking.py); at width 2 and 7 it does not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# Detectron-style colours (fractions of 255), indexed by object id
# (reference tools/painter.py colormap()).
_COLORS = np.array([
    [0.000, 0.000, 0.000], [1.000, 1.000, 1.000], [1.000, 0.498, 0.313],
    [0.392, 0.581, 0.929], [0.000, 0.447, 0.741], [0.850, 0.325, 0.098],
    [0.929, 0.694, 0.125], [0.494, 0.184, 0.556], [0.466, 0.674, 0.188],
    [0.301, 0.745, 0.933], [0.635, 0.078, 0.184], [0.300, 0.300, 0.300],
    [0.600, 0.600, 0.600], [1.000, 0.000, 0.000], [1.000, 0.500, 0.000],
    [0.749, 0.749, 0.000], [0.000, 1.000, 0.000], [0.000, 0.000, 1.000],
    [0.667, 0.000, 1.000],
], np.float32)


def colormap(index: int) -> Tuple[int, int, int]:
    """RGB colour of an object index."""
    c = _COLORS[index % len(_COLORS)]
    return tuple(int(round(v * 255)) for v in c)


def vis_add_mask(image_rgb: np.ndarray, mask: np.ndarray, color_index: int,
                 alpha: float) -> np.ndarray:
    """Alpha-blend the colour into the image where the mask is set
    (reference tools/painter.py:106-110)."""
    color = np.asarray(colormap(color_index), np.float32)
    img = image_rgb.astype(np.float32)
    m = mask.astype(bool)
    img[m] = img[m] * (1.0 - alpha) + color * alpha
    return img.clip(0, 255).astype(np.uint8)


def filled_circle(canvas: np.ndarray, center: Tuple[int, int], radius: int, value) -> np.ndarray:
    """``cv2.circle(canvas, center, radius, value, -1)`` in place: cv2's
    midpoint loop, each step filling the rows ``cy -+ dy`` over
    ``cx -+ dx`` and ``cy -+ dx`` over ``cx -+ dy``, clipped to the canvas."""
    cx, cy = int(center[0]), int(center[1])
    h, w = canvas.shape[:2]
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            if 0 <= y < h and cx - half < w and cx + half >= 0:
                canvas[y, max(cx - half, 0):min(cx + half, w - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1  # 0 while err <= 0, else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return canvas


def _spread_rows(out: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Every background run of a row (4-connected along it) that holds an
    ``out`` pixel becomes ``out`` entirely."""
    start = bg.copy()
    start[:, 1:] &= ~bg[:, :-1]
    run = np.cumsum(start.ravel()) * bg.ravel()  # run number on background, 0 elsewhere
    hit = np.bincount(run, weights=(out & bg).ravel(), minlength=int(run.max()) + 1) > 0
    hit[0] = False
    return hit[run].reshape(bg.shape)


def _outside(mask: np.ndarray) -> np.ndarray:
    """Background pixels 4-connected to the image's border (the background
    that surrounds the components; holes are not part of it), padded by one
    pixel: whole runs of rows and of columns at a time, until nothing grows."""
    bg = np.pad(~mask, 1, constant_values=True)
    out = np.zeros_like(bg)
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = True
    while True:
        grown = _spread_rows(_spread_rows(out, bg).T, bg.T).T
        if np.array_equal(grown, out):
            return out
        out = grown


def mask_contour(mask: np.ndarray, width: int = 3) -> np.ndarray:
    """Boolean band of the outer contours of a binary mask, ``width`` wide:
    the outer border pixels dilated by the disc ``filled_circle`` draws of
    radius 0 (width 1) or ``(width + 1) // 2``."""
    m = np.asarray(mask, bool)
    out = _outside(m)
    border = m & (out[:-2, 1:-1] | out[2:, 1:-1] | out[1:-1, :-2] | out[1:-1, 2:])
    r = 0 if width <= 1 else (width + 1) // 2
    disc = filled_circle(np.zeros((2 * r + 1, 2 * r + 1), np.uint8), (r, r), r, 1)
    h, w = m.shape
    band = np.zeros((h + 2 * r, w + 2 * r), bool)
    for dy, dx in zip(*np.nonzero(disc)):
        band[dy:dy + h, dx:dx + w] |= border
    return band[r:r + h, r:r + w]


def mask_painter(image_rgb: np.ndarray, mask: np.ndarray, mask_color: int = 5,
                 mask_alpha: float = 0.7, contour_color: int = 1,
                 contour_width: int = 3) -> np.ndarray:
    """A mask overlay plus its contour (reference tools/painter.py:137-160)."""
    out = vis_add_mask(image_rgb, mask, mask_color, mask_alpha)
    return vis_add_mask(out, mask_contour(mask, contour_width), contour_color, 1.0)


def point_painter(image_rgb: np.ndarray, points_xy: Sequence[Tuple[float, float]],
                  point_color: int = 5, point_alpha: float = 0.9,
                  point_radius: int = 15) -> np.ndarray:
    """Click or gesture points as filled discs (reference tools/painter.py:112-134)."""
    disc = np.zeros(image_rgb.shape[:2], np.uint8)
    for x, y in points_xy:
        filled_circle(disc, (int(x), int(y)), point_radius, 255)
    return vis_add_mask(image_rgb, disc > 0, point_color, point_alpha)


def multi_mask_painter(image_rgb: np.ndarray, index_mask: np.ndarray,
                       mask_alpha: float = 0.7) -> np.ndarray:
    """Every object of an indexed mask in its own colour."""
    out = image_rgb
    for label in np.unique(index_mask):
        if label != 0:
            out = mask_painter(out, index_mask == label, mask_color=int(label) + 2,
                               mask_alpha=mask_alpha)
    return out


def sam_visualization(image_rgb: np.ndarray, mask: np.ndarray,
                      points_xy: Optional[Sequence[Tuple[float, float]]] = None) -> np.ndarray:
    """SAM mask and prompt-point overlay (scripts/generate_sam*.py)."""
    out = mask_painter(image_rgb, mask)
    if points_xy:
        out = point_painter(out, points_xy, point_radius=8)
    return out


def make_colorwheel() -> np.ndarray:
    """Baker et al. (2007) optical-flow colour wheel: 55 RGB entries over
    the RY/YG/GC/CB/BM/MR sectors (reference utils/optical_flow_utils.py:4-51)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3), np.float32)
    col = 0
    for n, (a, b, ramp_up) in ((ry, (0, 1, True)), (yg, (0, 1, False)), (gc, (1, 2, True)),
                               (cb, (1, 2, False)), (bm, (2, 0, True)), (mr, (2, 0, False))):
        ramp = np.arange(n, dtype=np.float32) / n
        wheel[col:col + n, a] = 255 if ramp_up else 255 * (1 - ramp)
        wheel[col:col + n, b] = 255 * ramp if ramp_up else 255
        col += n
    return wheel


def flow_to_image(flow_uv: np.ndarray, clip_flow: Optional[float] = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """``[H, W, 2]`` flow -> uint8 colour image: hue the direction on the
    wheel, saturation the magnitude over the frame's largest
    (reference utils/optical_flow_utils.py:54-121)."""
    flow = np.clip(flow_uv, 0, clip_flow) if clip_flow is not None else flow_uv
    u, v = flow[..., 0], flow[..., 1]
    rad_max = max(np.sqrt(u * u + v * v).max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u * u + v * v)
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        c = ((1 - f) * wheel[k0, i] + f * wheel[k1, i]) / 255.0
        c = np.where(rad <= 1, 1 - rad * (1 - c), c * 0.75)
        img[..., 2 - i if convert_to_bgr else i] = np.floor(255 * c)
    return img
