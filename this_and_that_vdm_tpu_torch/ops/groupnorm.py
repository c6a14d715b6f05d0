"""K2: GroupNorm (+SiLU), hand-written for Hopper (``csrc/groupnorm.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/groupnorm_pallas.py`` (the Pallas
``_kernel`` launched by ``_gn_pallas``) and of the plain
``models/layers._group_norm`` it is held against.  The TPU kernel keeps one
[S, C] batch row in VMEM; the CUDA kernel splits each row's reduction over
many blocks (fp32 sums into an [N, G, 2] workspace with atomics) and then
applies the per-channel affine in a second elementwise pass, so it takes
every GroupNorm of the slice, the full-resolution VAE decoder sites
included.  See the source's header for the design.  Bound: bytes — three
passes (read, read, write) of the tensor, 82.6 MB at ``[28, 1536, 320]``
bf16.

``group_norm`` is the wrapper used by every GroupNorm of the port: on a CPU
tensor it takes the plain version, on a CUDA tensor it launches the kernel
or raises.  Its gradient (x, gamma, beta) is the JAX ``custom_vjp`` rule
(``models/layers.py`` ``_fused_gn_bwd``): the backward recomputes the plain
version and differentiates it (``_autograd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _autograd, _native

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_THREADS = 256
_MAX_CHANNELS = 4096
_STATS_ROWS = 64  # positions per stats block
_APPLY_BLOCKS = 264  # blocks per batch row in the apply pass (2 x 132 SMs)


def _group_norm(x, weight, bias, num_groups: int, eps: float):
    """Plain GroupNorm over channels-last ``x``; statistics over every
    non-batch axis (rank-5 ``[B, F, H, W, C]`` includes frames), fp32
    one-pass moments with the variance clamped at >= 0 (``layers.py:72-114``)."""
    c = x.shape[-1]
    xf = x.float()
    axes = tuple(range(1, x.dim() - 1))
    count = xf[0].numel() // c * (c // num_groups)
    s1 = xf.sum(dim=axes)  # [N, C]
    s2 = (xf * xf).sum(dim=axes)
    g1 = s1.reshape(-1, num_groups, c // num_groups).sum(-1)
    g2 = s2.reshape(-1, num_groups, c // num_groups).sum(-1)
    mean = g1 / count
    var = torch.clamp(g2 / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(c // num_groups, dim=-1)
    mean_c = mean.repeat_interleave(c // num_groups, dim=-1)
    w = inv_c * weight.float()[None, :]
    b = bias.float()[None, :] - mean_c * w
    shape = (x.shape[0],) + (1,) * len(axes) + (c,)
    return (xf * w.reshape(shape) + b.reshape(shape)).to(x.dtype)


def _plain(x, weight, bias, num_groups, eps, with_silu):
    out = _group_norm(x, weight, bias, num_groups, eps)
    return F.silu(out) if with_silu else out


def _launch(x, weight, bias, num_groups, eps, with_silu):
    global launches
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    ws = torch.zeros((n, num_groups, 2), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    is_bf16 = int(x.dtype == torch.bfloat16)
    stream = _native.stream_ptr(x)
    _native.launch("ttv_groupnorm_stats", x.data_ptr(), ws.data_ptr(), n, s, c,
                   num_groups, _STATS_ROWS, is_bf16, stream)
    blocks = max(1, min(_APPLY_BLOCKS, -(-s * c // (8 * _THREADS))))
    _native.launch("ttv_groupnorm_apply", x.data_ptr(), ws.data_ptr(), weight.data_ptr(),
                   bias.data_ptr(), y.data_ptr(), n, s, c, num_groups, float(eps),
                   int(with_silu), blocks, is_bf16, stream)
    launches += 1
    return y


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, with_silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, with_silu)
        return _launch(x, weight, bias, num_groups, eps, with_silu)

    @staticmethod
    def backward(ctx, grad):
        grads = _autograd.plain_vjp(lambda x, w, b: _plain(x, w, b, *ctx.args),
                                    ctx.saved_tensors, ctx.needs_input_grad[:3], grad)
        return grads + (None, None, None)


def group_norm(x, weight, bias, num_groups: int, eps: float, with_silu: bool = False):
    """GroupNorm of channels-last ``x`` ([N, ..., C]; every axis between the
    first and the last is folded into the statistics), optional SiLU."""
    if x.device.type == "cpu":
        return _plain(x, weight, bias, num_groups, eps, with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_norm: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous (channels-last)")
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    if c % num_groups or c % 8 or c > _MAX_CHANNELS:
        raise ValueError(f"group_norm: C={c} with G={num_groups} (C % G == 0, "
                         f"C % 8 == 0, C <= {_MAX_CHANNELS})")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")
    if s * c >= 2**31:
        raise ValueError(f"group_norm: batch row of {s * c} elements exceeds 2^31")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm: weight and bias must be [C]")
    weight = weight.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if _autograd.needs_grad(x, weight, bias):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, with_silu)
    return _launch(x, weight, bias, num_groups, eps, with_silu)
