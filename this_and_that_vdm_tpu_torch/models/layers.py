"""Shared primitives of the spatio-temporal diffusion stack (PyTorch).

Counterpart of ``this_and_that_vdm_tpu/models/layers.py``.  Public tensors
are channels-last (NHWC / ``[..., C]``), as in the JAX package; convolutions
hand cuDNN the same memory as an NCHW tensor in ``channels_last`` format
(``resnet.Conv2d``), which is the layout its tensor-core kernels want, so no
copy is made at either boundary.  Normalisation statistics and the attention
softmax run in fp32 whatever the compute dtype.

Parameter names are the HF/diffusers keys.  Norm parameters stay fp32 when a
model is cast to bf16 (``cast_compute_dtype``), as the JAX package keeps its
parameters fp32 and casts at each matmul.

The LayerNorm -> projection sites keep the structure of the JAX
``fused_ln()`` branch everywhere: the LayerNorm's parameters are handed to
the projection, which runs through ``ops.ln_matmul`` (K3) with a combined
``[3C, C]`` qkv weight for self-attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.groupnorm import group_norm
from ..ops.ln_matmul import layer_norm_fp32, ln_matmul


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0,
                         max_period: float = 10000.0) -> torch.Tensor:
    """diffusers ``Timesteps`` sinusoid, fp32 ``[B, dim]``."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, time_embed_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.Module):
    """GroupNorm of channels-last input through ``ops.groupnorm`` (K2);
    every axis between batch and channels is in the statistics."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 with_silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.with_silu = num_groups, eps, with_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x.contiguous(), self.weight, self.bias, self.num_groups,
                          self.eps, self.with_silu)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm_fp32(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head attention (diffusers ``Attention``): q/k/v without bias,
    ``to_out.0`` with bias; fp32 softmax.  ``ln``: the preceding LayerNorm,
    fused into the q (and, for self-attention, the combined qkv) projection
    through ``ops.ln_matmul``; ``x`` then arrives un-normalised."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(cross_attention_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(cross_attention_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None, ln: Optional[LayerNorm] = None):
        if ln is not None and context is None:
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], dim=0)
            q, k, v = ln_matmul(x, ln.weight, ln.bias, w, eps=ln.eps).chunk(3, dim=-1)
        else:
            ctx = x if context is None else context
            q = self.to_q(x) if ln is None else ln_matmul(x, ln.weight, ln.bias,
                                                           self.to_q.weight, eps=ln.eps)
            k, v = self.to_k(ctx), self.to_v(ctx)
        b, s, _ = q.shape
        skv = k.shape[1]
        q = q.reshape(b, s, self.heads, self.dim_head)
        k = k.reshape(b, skv, self.heads, self.dim_head)
        v = v.reshape(b, skv, self.heads, self.dim_head)
        out = dot_product_attention(q, k, v).reshape(b, s, self.heads * self.dim_head)
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward (HF keys ``net.0.proj``, ``net.2``); ``ln`` is
    fused into the first projection through ``ops.ln_matmul``."""

    def __init__(self, dim: int, mult: int = 4, dim_out: Optional[int] = None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim_out or dim)])

    def forward(self, x, ln: Optional[LayerNorm] = None):
        proj = self.net[0].proj
        if ln is not None:
            h = ln_matmul(x, ln.weight, ln.bias, proj.weight, proj.bias, eps=ln.eps)
        else:
            h = proj(x)
        h, gate = h.chunk(2, dim=-1)
        # exact GELU in fp32, rounded once to h's dtype (torch's bf16 GELU
        # computes in fp32 internally: the JAX fp32 upcast without the copies)
        h = h * F.gelu(gate)
        return self.net[2](h)


class AlphaBlender(nn.Module):
    """Learned spatial/temporal mixer (diffusers AlphaBlender)."""

    def __init__(self, merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        if merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(merge_strategy)
        self.merge_strategy = merge_strategy
        self.switch = switch_spatial_to_temporal_mix
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if self.merge_strategy == "learned_with_images" and image_only_indicator is not None:
            ind = image_only_indicator.bool()
            alpha = torch.where(ind, torch.ones_like(ind, dtype=torch.float32), alpha)
            if x_spatial.dim() == 3:  # tokens folded as [B*F, S, C]
                alpha = alpha.reshape(-1, 1, 1)
            else:  # [B, F, ...spatial..., C]
                alpha = alpha.reshape(alpha.shape + (1,) * (x_spatial.dim() - alpha.dim()))
        alpha = alpha.to(x_spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


_NORMS = (GroupNorm, LayerNorm, AlphaBlender, nn.LayerNorm)


def cast_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matmul / conv / embedding parameters of ``module`` to
    ``dtype`` in place; norm and mixer parameters stay fp32."""
    for m in module.modules():
        if isinstance(m, _NORMS):
            continue
        for name, p in m.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded fan-in-scaled normal init of every matmul / conv weight
    (std = 1 / sqrt(fan_in)); biases N(0, 0.02); norm scales
    1 + N(0, 0.02) and shifts N(0, 0.02), so no GroupNorm sees constant
    groups.  Draws on the generator's device."""
    dev = generator.device
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, _NORMS):
                if name == "weight":
                    noise = torch.randn(p.shape, generator=generator, device=dev)
                    p.copy_(1.0 + 0.02 * noise)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=dev))
            elif name == "weight" and p.dim() >= 2:
                fan_in = p[0].numel() if not isinstance(m, nn.Embedding) else 1
                std = 1.0 / math.sqrt(fan_in)
                p.copy_(std * torch.randn(p.shape, generator=generator, device=dev))
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator, device=dev))
    return module
