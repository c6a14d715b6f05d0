"""K1: spatial self-attention, hand-written for Hopper (``csrc/flash_attention.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/flash_attention.py``.  The TPU
kernel (``_kernel``, launched by ``_flash_call``) computes one fp32 [BQ, S]
score tile per program in VMEM.  The CUDA kernel streams K/V in tiles of 64
keys with an online softmax instead, because a block's shared memory holds
227 KB, not megabytes; see the source's header for its design.  Bound at
the slice's main site ``[28, 1536, 5, 64]`` bf16: 84.6 GFLOP against 110 MB
of q/k/v/o, i.e. tensor-core bound.

``flash_attention`` is the wrapper: on a CPU tensor it takes the plain
version (``_plain``), on a CUDA tensor it launches the kernel or raises.
The custom_partitioning / shard_map builds of the TPU file are mesh
mechanics and have no counterpart here.
"""

from __future__ import annotations

import torch

from . import _native
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


def flash_attention(q, k, v, scale: float):
    """q, k, v: [B, S, H, D] -> [B, S, H, D] (forward only)."""
    global launches
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    _native.launch("ttv_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b, s, h, d, float(scale),
                   int(q.dtype == torch.bfloat16), _native.stream_ptr(q))
    launches += 1
    return out
