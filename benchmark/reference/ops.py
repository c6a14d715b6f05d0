"""Plain PyTorch primitives of the reference models.

Every product of the reference (linear, convolution, attention) goes through
this file, so one switch sets the precision of all of them:

* ``fp32`` (the reference): float32 operands, TF32 off.
* ``bf16``: each operand rounded to bfloat16, then an fp32 product: the
  step below an fp32 configuration.
* ``fp8``: each operand scaled per tensor to the float8 e4m3 range and
  rounded there: the step below a bf16 configuration.

``record()`` collects the calls that the measured program routes to its own
kernels (every GroupNorm, every LayerNorm -> projection site), with their
shapes, for the byte and operation counts of the roofline metrics.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

_MODE = "fp32"
_RECORD: Optional[list] = None
FP8_MAX = 448.0


@contextlib.contextmanager
def precision(mode: str):
    """Run the reference's products at ``mode`` (``fp32``, ``bf16``, ``fp8``)."""
    global _MODE
    if mode not in ("fp32", "bf16", "fp8"):
        raise ValueError(mode)
    old, _MODE = _MODE, mode
    try:
        yield
    finally:
        _MODE = old


@contextlib.contextmanager
def record():
    """Collect ``(kind, shape...)`` of each GroupNorm and LN -> projection call."""
    global _RECORD
    old, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = old


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN around the reference's own computation."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _q(t: torch.Tensor) -> torch.Tensor:
    """An operand at the current precision (returned in fp32)."""
    t = t.float()
    if _MODE == "fp32" or t.device.type == "meta":
        return t
    if _MODE == "bf16":
        return t.to(torch.bfloat16).float()
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x, w, b=None):
    out = torch.matmul(_q(x), _q(w).t())
    return out if b is None else out + b.float()


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0):
    """Channels-last ``[N, H, W, C]`` -> ``[N, H', W', O]``."""
    out = F.conv2d(_q(x.permute(0, 3, 1, 2)), _q(w), None if b is None else b.float(),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def temporal_conv(x, w, b):
    """(3,1,1) convolution over the frames of ``[B, F, H, W, C]``; ``w`` is
    the ``[O, I, 3, 1, 1]`` Conv3d weight."""
    out = F.conv3d(_q(x.permute(0, 4, 1, 2, 3)), _q(w), b.float(), padding=(1, 0, 0))
    return out.permute(0, 2, 3, 4, 1)


def attention(q, k, v, mask=None):
    """``[B, S, H, D]`` queries against ``[B, K, H, D]`` keys and values."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", _q(q), _q(k)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", _q(probs), _q(v))


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def ln_linear(x, ln_w, ln_b, eps: float, w, b=None):
    """LayerNorm then a projection: a site the program fuses."""
    if _RECORD is not None:
        _RECORD.append(("ln_matmul", math.prod(x.shape[:-1]), x.shape[-1], w.shape[0]))
    return linear(layer_norm(x, ln_w, ln_b, eps), w, b)


def group_norm(x, w, b, groups: int, eps: float, silu: bool = False):
    """GroupNorm of channels-last ``[N, ..., C]``: statistics over every axis
    but the first and the last, per group of channels; two-pass moments."""
    if _RECORD is not None:
        _RECORD.append(("groupnorm", x.numel()))
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w.float() + b.float()
    return F.silu(y) if silu else y
