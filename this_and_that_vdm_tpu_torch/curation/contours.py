"""cv2's outer contours and their thick outline, in numpy and plain Python:
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)`` followed by
``cv2.drawContours(band, contours, -1, 255, width)``, pixel for pixel (the
card's machine has no cv2).

* :func:`find_external_contours` is the border following of OpenCV's
  ``cvFindNextContour`` / ``icvFetchContour`` (Suzuki and Abe) in external
  mode: the image padded with a zero border, scanned row by row; a 0 -> 1
  step starts an outer border unless the last border pixel met on the row
  is marked as one whose right neighbour is an object pixel; every border
  pixel is marked as it is followed, and its points are listed in cv2's
  order.
* :func:`draw_contours` draws each contour as cv2 does: a ``ThickLine``
  from each point to the next (the last to the first), that is a quad of
  half-width ``width / 2`` in 16-bit fixed point filled by
  ``FillConvexPoly`` (its outline drawn by ``Line2`` after ``clipLine``)
  and a filled circle of radius ``(width + 1) // 2`` at the segment's end.
  Width 1 is the contour's own points.  Away from the image's edge a
  segment's quad depends only on its direction, so it is stamped from one
  drawing a direction; a segment whose quad reaches the edge is drawn in
  full, clipping included.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

Contour = List[Tuple[int, int]]

# chain code s -> (dx, dy): 0 is +x, counting anticlockwise on screen
_CODE = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT_BOUND = -126  # cv2's mark (nbd | -128) of a border pixel with background to its right
_SHIFT = 16  # drawing.cpp XY_SHIFT
_ONE = 1 << _SHIFT


def find_external_contours(mask: np.ndarray) -> List[Contour]:
    """The outer contours of a binary ``[H, W]`` mask (non-zero is object)
    as lists of ``(x, y)``, in cv2's order and with cv2's points."""
    h, w = mask.shape
    stride = w + 2
    img = np.zeros((h + 2, stride), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    buf = img.ravel().tolist()
    d8 = (1, -stride + 1, -stride, -stride - 1, -1, stride - 1, stride, stride + 1)
    deltas = d8 + d8
    out = []
    for y in range(1, h + 1):
        base = y * stride
        lnbd = base  # the last border pixel met on this row
        prev, x = 0, 1
        while x < stride - 1:
            p = buf[base + x]
            if p == prev:
                x += 1
                continue
            start = prev == 0 and p == 1 and buf[lnbd] <= 0
            if not start and p == 0 and prev >= 1 and prev & -2:  # a hole's border
                lnbd = base + x - 1
            if start:
                lnbd = base + x
                out.append(_follow(buf, base + x, x - 1, y - 1, deltas))
                prev = buf[base + x]
            else:
                prev = p
                if prev & -2:
                    lnbd = base + x
            x += 1
    return out


def _follow(buf: list, i0: int, x: int, y: int, deltas) -> Contour:
    """``icvFetchContour`` of an outer border from pixel ``i0`` (at ``(x,
    y)``), marking the border in ``buf``; every point kept."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if buf[i1] != 0 or s == s_end:
            break
    if buf[i1] == 0:  # a lone pixel
        buf[i0] = _RIGHT_BOUND
        return [(x, y)]
    pts, i3 = [], i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if buf[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            buf[i3] = _RIGHT_BOUND
        elif buf[i3] == 1:
            buf[i3] = 2
        pts.append((x, y))
        x, y = x + _CODE[s][0], y + _CODE[s][1]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


# ------------------------------------------------------------ cv2 drawing

def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """drawing.cpp ``clipLine`` on a ``w x h`` canvas -> (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _put(img: np.ndarray, x: int, y: int) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = True


def _line2(img: np.ndarray, p1, p2) -> None:
    """drawing.cpp ``Line2``: a fixed-point (16-bit) line, 8-connected."""
    h, w = img.shape
    inside, (x1, y1), (x2, y2) = _clip_line(w << _SHIFT, h << _SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dx) <= abs(dy)
    ax, ay = abs(dx), abs(dy)
    if not steep:
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        y_step = _cdiv(dy << _SHIFT, ax | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        x_step = _cdiv(dx << _SHIFT, ay | 1)
        count = (y2 - y1) >> _SHIFT
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    _put(img, (x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT)
    if not steep:
        x1 >>= _SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> _SHIFT)
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= _SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> _SHIFT, y1)
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex(img: np.ndarray, v) -> None:
    """drawing.cpp ``FillConvexPoly`` of 16-bit fixed-point vertices, line
    type 8: the outline by ``Line2``, then the rows between the two edges
    walked down from the top vertex."""
    h, w = img.shape
    delta = _ONE >> 1
    n = len(v)
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p)
        p0 = p
    xmin = (min(p[0] for p in v) + delta) >> _SHIFT
    xmax = (max(p[0] for p in v) + delta) >> _SHIFT
    ymin = (min(ys) + delta) >> _SHIFT
    ymax = (max(ys) + delta) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, step, x, dx, end row]
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    left_edges, y = n, ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while left_edges > 0:
                    left_edges -= 1
                    ty = (v[idx][1] + delta) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[0], e[2], e[4] = idx, xs, ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0, idx = idx, (idx + e[1]) % n
                else:
                    left_edges = -1
        if left_edges < 0:
            return
        if y >= 0:
            lo, hi = sorted((edge[0][2], edge[1][2]))
            xx1, xx2 = (lo + delta) >> _SHIFT, (hi + delta) >> _SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = True
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            return


def _segment_quad(img: np.ndarray, p0, p1, width: int) -> None:
    """The quad of drawing.cpp ``ThickLine`` from ``p0`` to ``p1`` (pixels),
    ``width`` > 1; nothing for a segment of no length."""
    x0, y0, x1, y1 = (c << _SHIFT for c in (*p0, *p1))
    dx, dy = (x0 - x1) / _ONE, (y1 - y0) / _ONE
    r = dx * dx + dy * dy
    if r <= 2.220446049250313e-16:
        return
    r = ((width << (_SHIFT - 1)) + (width & 1) * _ONE * 0.5) / math.sqrt(r)
    ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
    _fill_convex(img, [(x0 + ex, y0 + ey), (x0 - ex, y0 - ey), (x1 - ex, y1 - ey),
                       (x1 + ex, y1 + ey)])


def _stamp(points: np.ndarray, offsets: np.ndarray, shape, pad: int) -> np.ndarray:
    """``[H, W]`` bool: every offset ``(dy, dx)`` of every point ``(x, y)``."""
    h, w = shape
    out = np.zeros((h + 2 * pad, w + 2 * pad), bool)
    if len(points):
        seeds = np.zeros((h, w), bool)
        seeds[points[:, 1], points[:, 0]] = True
        for dy, dx in offsets:
            out[pad + dy:pad + dy + h, pad + dx:pad + dx + w] |= seeds
    return out[pad:pad + h, pad:pad + w]


def draw_contours(shape: Tuple[int, int], contours: List[Contour], width: int) -> np.ndarray:
    """``cv2.drawContours(zeros(shape), contours, -1, 255, width) > 0``."""
    from .painters import filled_circle

    h, w = shape
    band = np.zeros(shape, bool)
    pts = np.array([p for c in contours for p in c], np.int64).reshape(-1, 2)
    if width <= 1 or not len(pts):
        band[pts[:, 1], pts[:, 0]] = True
        return band
    radius = ((width << (_SHIFT - 1)) + (_ONE >> 1)) >> _SHIFT
    pad = radius + width + 2
    size = 2 * pad + 1
    disc = filled_circle(np.zeros((size, size), np.uint8), (pad, pad), radius, 1)
    band |= _stamp(pts, np.argwhere(disc) - pad, shape, pad)
    # each segment (previous point -> point), by direction
    ends = [np.asarray(c, np.int64) for c in contours if len(c) > 1]
    if not ends:
        return band
    p1 = np.concatenate(ends)
    p0 = np.concatenate([np.roll(c, 1, axis=0) for c in ends])
    edge = ((np.minimum(p0, p1) < pad).any(1) | (p0[:, 0] >= w - pad) | (p1[:, 0] >= w - pad)
            | (p0[:, 1] >= h - pad) | (p1[:, 1] >= h - pad))
    for a, b in zip(p0[edge].tolist(), p1[edge].tolist()):
        _segment_quad(band, a, b, width)
    step = p1 - p0
    for d in {tuple(s) for s in step[~edge].tolist()}:
        quad = np.zeros((size, size), bool)
        _segment_quad(quad, (pad, pad), (pad + d[0], pad + d[1]), width)
        sel = ~edge & (step == d).all(1)
        band |= _stamp(p0[sel], np.argwhere(quad) - pad, shape, pad)
    return band
