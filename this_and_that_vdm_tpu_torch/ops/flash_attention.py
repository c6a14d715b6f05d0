"""K1: spatial self-attention, hand-written for Hopper (``csrc/flash_attention.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/flash_attention.py``.  The TPU
kernel (``_kernel``, launched by ``_flash_call``) computes one fp32 [BQ, S]
score tile per program in VMEM.  The CUDA kernel streams K/V tiles with an
online softmax instead, because a block's shared memory holds 227 KB, not
megabytes; in bf16 it runs on wgmma with TMA loads, in fp32 on mma.sync in
3xTF32 with cp.async loads (the source's header has the designs).  Bound at
the slice's main site ``[28, 1536, 5, 64]`` bf16: 84.6 GFLOP against 110 MB
of q/k/v/o, i.e. tensor-core bound.

The kernel reads q, k and v in place through their strides (the TMA
descriptors are 4-D over (D, H, S, B)), so the ``.chunk(3)`` views of a
fused qkv product need no copy; ``layout_error`` says which layouts it
takes.

``flash_attention`` is the wrapper: on a CPU tensor it takes the plain
version (``_plain``), on a CUDA tensor it launches the kernel or raises.
Its gradient is the JAX ``custom_vjp`` rule (``_flash_bwd``): the backward
recomputes the plain version and differentiates it (``_autograd``).
The custom_partitioning / shard_map builds of the TPU file are mesh
mechanics and have no counterpart here.
"""

from __future__ import annotations

import torch

from . import _autograd, _native
from .attention import _xla_attention as _plain

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_SUPPORTED_HEAD_DIM = (64, 128)
_BLOCK_Q_CANDIDATES = (512, 256, 128)
_MAX_SCORE_ELEMS = 1 << 20
_MAX_SEQ = 4096


def _block_q(s: int):
    for bq in _BLOCK_Q_CANDIDATES:
        if s % bq == 0 and bq * s <= _MAX_SCORE_ELEMS:
            return bq
    return None


def supports(q, k, v) -> bool:
    """The JAX ``supports()`` rule without its backend check: the same
    attention sites take the kernel in both packages (UNet / ControlNet
    spatial self-attention, S = 1536 and 384 at D = 64)."""
    if k.shape != q.shape or v.shape != q.shape or q.dim() != 4:
        return False
    s, d = q.shape[1], q.shape[3]
    if d not in _SUPPORTED_HEAD_DIM or s > _MAX_SEQ or _block_q(s) is None:
        return False
    return q.dtype in (torch.float32, torch.bfloat16)


def _seq_strides(t):
    """(batch stride, row stride) in elements; a size-1 axis gets the stride
    of a contiguous tensor, which the kernel never steps along."""
    b, s, h, d = t.shape
    ss = t.stride(1) if s > 1 else h * d
    return (t.stride(0) if b > 1 else s * ss), ss


def layout_error(q, k, v):
    """Why the kernel cannot read q, k, v as they lie, or None when it can:
    equal [B, S, H, D] shapes and strides, unit stride inside a head, head
    stride D, batch and row strides that are multiples of 8 elements (16
    bytes in bf16, as TMA needs) and 16-byte-aligned data."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        return (f"q/k/v must be equal [B,S,H,D], got {tuple(q.shape)} {tuple(k.shape)} "
                f"{tuple(v.shape)}")
    if k.stride() != q.stride() or v.stride() != q.stride():
        return f"q, k, v strides differ: {q.stride()} {k.stride()} {v.stride()}"
    h, d = q.shape[2:]
    if q.stride(3) != 1 or (h > 1 and q.stride(2) != d):
        return f"needs unit stride inside a head and head stride D={d}, got {q.stride()}"
    if any(st % 8 for st in _seq_strides(q)):
        return f"batch and row strides must be multiples of 8 elements, got {q.stride()}"
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        return "q, k, v must be 16-byte aligned"
    return None


def _launch(q, k, v, scale: float):
    global launches
    b, s, h, d = q.shape
    sb, ss = _seq_strides(q)
    out = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    _native.launch("ttv_flash_attention", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b, s, h, d, sb, ss, float(scale),
                   int(q.dtype == torch.bfloat16))
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        grads = _autograd.plain_vjp(lambda q, k, v: _plain(q, k, v, ctx.scale),
                                    ctx.saved_tensors, ctx.needs_input_grad[:3], grad)
        return grads + (None,)


def flash_attention(q, k, v, scale: float):
    """q, k, v: [B, S, H, D] (views too, see ``layout_error``) -> contiguous
    [B, S, H, D]."""
    if q.device.type == "cpu":
        return _plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v must be equal [B,S,H,D], got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, d = q.shape
    if d not in _SUPPORTED_HEAD_DIM or not 0 < s <= _MAX_SEQ:
        raise ValueError(f"flash_attention: needs D in {_SUPPORTED_HEAD_DIM} and "
                         f"S <= {_MAX_SEQ}, got S={s} D={d}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    err = layout_error(q, k, v)
    if err is not None:
        raise ValueError(f"flash_attention: {err}")
    if _autograd.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale)
    return _launch(q, k, v, scale)
