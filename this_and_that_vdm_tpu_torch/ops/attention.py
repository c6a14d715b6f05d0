"""Attention compute paths (counterpart of ``this_and_that_vdm_tpu/ops/attention.py``).

``dot_product_attention`` routes by shape: the shapes K1 takes
(``flash_attention.supports``) go through its wrapper, every other site
(cross-attention, temporal S=14, VAE D=512, CLIP D=80) takes the plain einsum
path, as it takes XLA outside any Pallas kernel in JAX.

Shapes follow ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _xla_attention(q, k, v, scale):
    """fp32 scores and softmax (JAX's preferred_element_type=float32), no
    mask; probabilities cast to q's dtype before P@V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention, fp32 softmax, no masking."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    from . import flash_attention as fa

    if fa.supports(q, k, v):  # reads the qkv .chunk(3) views in place
        return fa.flash_attention(q, k, v, scale)
    return _xla_attention(q, k, v, scale)
