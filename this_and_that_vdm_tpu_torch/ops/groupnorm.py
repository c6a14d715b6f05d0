"""K2: GroupNorm (+SiLU), hand-written for Hopper (``csrc/groupnorm.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/groupnorm_pallas.py`` (the Pallas
``_kernel`` launched by ``_gn_pallas``) and of the plain
``models/layers._group_norm`` it is held against.  The TPU kernel keeps one
[S, C] batch row in VMEM and reads it once.  The CUDA kernel is one
cooperative launch over contiguous slabs of rows, one slab a block, whose
per-(row, group) partial sums meet across one grid barrier; :func:`plan`
picks its route by shape before the launch:

- **resident**: the tensor fits in the card's shared memory (one block an
  SM, slab + reduction buffers within 227 KB): one read and one write, as on
  the TPU.  Every denoise-step site up to 27.5 MB and the batch-1 fp32
  train sites take it.
- **streamed**: anything larger (the 55-83 MB skip-concat sites, the VAE
  decoder): two blocks an SM, the slab read for the statistics and again,
  in reverse, for the output.

There is no fallback from one route to the other: a refused launch raises.
Bound: bytes, one read and one write (55.1 MB at ``[28, 1536, 320]`` bf16).

``group_norm`` is the wrapper used by every GroupNorm of the port: on a CPU
tensor it takes the plain version, on a CUDA tensor it launches the kernel
or raises.  Its gradient (x, gamma, beta) is the JAX ``custom_vjp`` rule
(``models/layers.py`` ``_fused_gn_bwd``): the backward recomputes the plain
version and differentiates it (``_autograd``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _autograd, _native

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

THREADS = 256  # a block (csrc/groupnorm.cu)
MAX_CHANNELS = 4096  # 16 channels a thread
SMEM_LIMIT = 232448  # shared memory a block can use on sm_90
_STATIC_SMEM = 1024  # the kernel's mbarriers, with room to spare
MIN_SLAB = 16384  # bytes a resident block holds at least (small tensors take fewer SMs)
STREAMED_BLOCKS_PER_SM = 2  # the streamed kernel's __launch_bounds__


class Plan(NamedTuple):
    resident: bool
    grid: int  # blocks, all resident at once
    rows_per_block: int  # block b owns rows [b * rpb, min(rows, (b + 1) * rpb))
    kmax: int  # batch rows (segments) a block touches at most
    smem: int  # dynamic shared memory a block, bytes


def _kmax(rows: int, s: int, rpb: int) -> int:
    """Batch rows a slab of ``rpb`` rows meets at most."""
    return max((min(rows, (b + 1) * rpb) - 1) // s - b * rpb // s + 1
               for b in range(-(-rows // rpb)))


@functools.lru_cache(maxsize=1024)
def plan(n: int, s: int, c: int, groups: int, itemsize: int, sms: int = 132) -> Plan:
    """How the kernel takes ``[n, s, c]`` of ``itemsize``-byte elements on a
    card with ``sms`` SMs: resident when each block's slab of rows plus its
    reduction buffers fit in one SM's shared memory, else streamed."""
    rows, row_bytes = n * s, c * itemsize
    lanes = min(c // (16 // itemsize), THREADS)  # threads across one row
    rif = THREADS // lanes  # rows walked at once

    def small(kmax):  # per-channel partials, then (mean, rstd) per segment and group
        return 4 * (2 * rif * c + 2 * groups * kmax)

    grid = max(1, min(sms, -(-rows * row_bytes // MIN_SLAB), rows))
    rpb = -(-rows // grid)
    kmax = _kmax(rows, s, rpb)
    if rpb * row_bytes + small(kmax) <= SMEM_LIMIT - _STATIC_SMEM:
        return Plan(True, -(-rows // rpb), rpb, kmax, rpb * row_bytes + small(kmax))
    rpb = -(-rows // min(sms * STREAMED_BLOCKS_PER_SM, rows))
    kmax = _kmax(rows, s, rpb)
    return Plan(False, -(-rows // rpb), rpb, kmax, small(kmax))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    p = plan(n, s, c, num_groups, x.element_size(), _sm_count(x.device.index))
    part = torch.empty((p.grid * p.kmax * num_groups * 2,), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    _native.launch("ttv_groupnorm", x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                   y.data_ptr(), part.data_ptr(), n * s, s, c, num_groups, float(eps),
                   int(with_silu), p.rows_per_block, p.kmax, p.grid, int(p.resident), p.smem,
                   int(x.dtype == torch.bfloat16))
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
    if x.numel() == 0:
        raise ValueError(f"group_norm: empty input {tuple(x.shape)}")
    s = x.numel() // (n * c)
    if c % num_groups or c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"group_norm: C={c} with G={num_groups} (C % G == 0, "
                         f"C % 8 == 0, C <= {MAX_CHANNELS})")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")
    if n * s >= 2**30:
        raise ValueError(f"group_norm: {n * s} positions exceed 2^30")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm: weight and bias must be [C]")
    weight = weight.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if _autograd.needs_grad(x, weight, bias):
        return _GroupNorm.apply(x, weight, bias, num_groups, eps, with_silu)
    return _launch(x, weight, bias, num_groups, eps, with_silu)
