"""CLIP text / vision encoders (counterpart of ``models/clip.py``).

* ``CLIPVisionModelWithProjection`` — ViT-H/14 (hidden 1280, 32 layers, 16
  heads, patch 14, projection to 1024): the single image token.
* ``CLIPTextModel`` — SD2.1 text encoder (hidden 1024, 23 layers, causal,
  77 positions): the 77 text tokens.

Module paths are the transformers state-dict keys (``text_model.encoder.
layers.N.self_attn.q_proj``, ``vision_model.embeddings.class_embedding``,
``visual_projection``), so a transformers checkpoint loads without a
converter (its ``position_ids`` buffers aside).  The causal branch stays
plain tensor code, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import LayerNorm
from .resnet import Conv2d


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_positions: int = 77
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny():
        return CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_positions=16)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny():
        return CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                                intermediate_size=64, patch_size=8, image_size=32,
                                projection_dim=24)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, causal: bool):
        b, s, c = x.shape
        d = c // self.heads
        q, k, v = (m(x).reshape(b, s, self.heads, d)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        if causal:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
            mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        else:
            o = dot_product_attention(q, k, v)
        return self.out_proj(o.reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # fp32 inside, one rounding (layers.FeedForward)


class CLIPLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, eps: float):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, eps)
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm2 = LayerNorm(hidden, eps)
        self.mlp = CLIPMLP(hidden, intermediate)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, num_layers: int, hidden: int, heads: int, intermediate: int,
                 eps: float):
        super().__init__()
        self.layers = nn.ModuleList([CLIPLayer(hidden, heads, intermediate, eps)
                                     for _ in range(num_layers)])

    def forward(self, x, causal: bool):
        for layer in self.layers:
            x = layer(x, causal)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.intermediate_size, cfg.layer_norm_eps)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """``input_ids`` [B, S] -> ``last_hidden_state`` [B, S, hidden]."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids):
        tm = self.text_model
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)[None]
        x = tm.encoder(x, causal=True)
        return tm.final_layer_norm(x)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, padding=0, bias=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                                   cfg.intermediate_size, cfg.layer_norm_eps)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    """``pixel_values`` [B, H, W, 3] (CLIP-normalised) -> ``image_embeds``
    [B, projection_dim]."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)

    def forward(self, pixel_values):
        vm, emb = self.vision_model, self.vision_model.embeddings
        dtype = emb.patch_embedding.weight.dtype
        b = pixel_values.shape[0]
        patches = emb.patch_embedding(pixel_values.to(dtype)).reshape(b, -1, self.config.hidden_size)
        cls = emb.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        x = vm.pre_layrnorm(x + emb.position_embedding(pos)[None])
        x = vm.encoder(x, causal=False)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
