"""Antialiased resize (CLIP preprocessing) as dense separable matrices.

Counterpart of ``this_and_that_vdm_tpu/ops/resize.py``: a skimage-rule
Gaussian blur (sigma = max((scale-1)/2, 1e-3), kernel ``int(max(4*sigma, 3))``
made odd, reflect padding) followed by bicubic interpolation with
``align_corners=True`` (A = -0.75).  Each 1-D operation is a small matrix
built once in numpy, so the whole resize is two matmuls:
``out = M_h @ img @ M_w^T`` with ``M = Interp @ Blur``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_CUBIC_A = -0.75


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = _CUBIC_A
    return np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def bicubic_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """``[out_size, in_size]`` matrix of bicubic ``align_corners=True``."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = 0.0 if out_size == 1 else (in_size - 1) / (out_size - 1)
    offsets = np.array([-1, 0, 1, 2])
    for i in range(out_size):
        src = i * scale
        j0 = int(np.floor(src))
        for off, w in zip(offsets, _cubic_kernel(offsets - (src - j0))):
            m[i, min(max(j0 + off, 0), in_size - 1)] += w  # clamp at borders
    return m


def _reflect_index(j: int, size: int) -> int:
    """torch 'reflect' padding index (no edge repeat)."""
    if size == 1:
        return 0
    period = 2 * (size - 1)
    j = abs(j) % period
    return period - j if j >= size else j


def gaussian_blur_matrix(size: int, kernel_size: int, sigma: float) -> np.ndarray:
    """``[size, size]`` 1-D Gaussian blur with reflect padding."""
    x = np.arange(kernel_size, dtype=np.float64) - kernel_size // 2
    if kernel_size % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    m = np.zeros((size, size), dtype=np.float64)
    pad_front = (kernel_size - 1) // 2
    for i in range(size):
        for k in range(kernel_size):
            m[i, _reflect_index(i - pad_front + k, size)] += g[k]
    return m


def _antialias_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    sigma = max((in_size / out_size - 1.0) / 2.0, 0.001)
    ks = int(max(2.0 * 2 * sigma, 3))
    if ks % 2 == 0:
        ks += 1
    blur = gaussian_blur_matrix(in_size, ks, sigma)
    return (bicubic_matrix_align_corners(in_size, out_size) @ blur).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _antialias_matrices(in_h: int, in_w: int, out_h: int, out_w: int):
    return _antialias_axis_matrix(in_h, out_h), _antialias_axis_matrix(in_w, out_w)


def resize_with_antialiasing(img: torch.Tensor, size: tuple) -> torch.Tensor:
    """Antialiased bicubic resize of ``[..., H, W]`` to ``[..., size[0], size[1]]``."""
    m_h, m_w = _antialias_matrices(img.shape[-2], img.shape[-1], size[0], size[1])
    m_h = torch.from_numpy(m_h).to(img.device, img.dtype)
    m_w = torch.from_numpy(m_w).to(img.device, img.dtype)
    out = torch.einsum("oh,...hw->...ow", m_h, img)
    return torch.einsum("pw,...hw->...hp", m_w, out)
