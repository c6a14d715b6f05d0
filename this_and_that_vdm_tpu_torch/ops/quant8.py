"""Closed-form log-codebook 8-bit quantiser element math (torch).

Counterpart of ``this_and_that_vdm_tpu/ops/quant8.py``, the single source of
the codebook that the 8-bit AdamW state uses (``training/optimizers.py``)
and that K4 (``ops/adam8bit.py``, ``csrc/adam8bit.cu``) repeats in CUDA.

Codebook (magnitudes ``10**linspace(-DECADES, 0, n_mags)``):
  * signed   (first moment, n_mags=127): [0..126] = -mags reversed,
    [127] = 0, [128..254] = +mags
  * unsigned (second moment, n_mags=255): [0] = 0, [1..255] = mags

Encode is the nearest codebook entry by linear midpoints, computed in
closed form from one ``log2``; decode is one ``exp2``.  No table gather.
The Python-float constants (``mid * lo``, ``lo * 1e-6``, ``step * LOG2_10``)
are folded in float64 and enter the fp32 arithmetic as fp32 scalars, as the
JAX package's jnp code folds them.
"""

from __future__ import annotations

import torch

BLOCK = 256  # quantisation block (per-block fp32 absmax scale)
DECADES = 7.0  # relative dynamic range 1e-7 .. 1
LOG2_10 = 3.321928094887362


def log_index(a: torch.Tensor, n_mags: int):
    """Nearest-magnitude codebook index of ``a`` (non-negative, <= 1):
    (float index in [0, n_mags - 1], mask of the below-smallest-midpoint
    bucket that encodes as zero)."""
    step = DECADES / (n_mags - 1)
    mid = (1.0 + 10.0 ** step) / 2.0
    lo = 10.0 ** (-DECADES)
    j = torch.floor(torch.log2(torch.clamp(a, min=lo * 1e-6) / (mid * lo))
                    / (step * LOG2_10)) + 1.0
    return torch.clamp(j, 0.0, n_mags - 1.0), a < lo / 2.0


def encode(v: torch.Tensor, signed: bool, n_mags: int) -> torch.Tensor:
    """Normalised values (|v| <= 1) -> float codebook indices."""
    j, zero = log_index(v.abs(), n_mags)
    if signed:
        return torch.where(zero, 127.0, torch.where(v >= 0.0, 128.0 + j, 126.0 - j))
    return torch.where(zero, 0.0, 1.0 + j)


def decode(qf: torch.Tensor, signed: bool, n_mags: int) -> torch.Tensor:
    """Float codebook indices -> signed magnitudes (unscaled)."""
    step = DECADES / (n_mags - 1)
    if signed:
        j = torch.where(qf >= 128.0, qf - 128.0, 126.0 - qf)
        sign = torch.where(qf == 127.0, 0.0, torch.where(qf >= 128.0, 1.0, -1.0))
    else:
        j = qf - 1.0
        sign = torch.where(qf == 0.0, 0.0, 1.0)
    return sign * torch.exp2((j * step - DECADES) * LOG2_10)
