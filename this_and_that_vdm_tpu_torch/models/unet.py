"""UNetSpatioTemporalConditionModel — the SVD denoiser (counterpart of
``models/unet.py``).

Config ``in_channels=8`` (4 noisy + 4 first-frame latents), ``out_channels=4``,
``block_out_channels=(320,640,1280,1280)``, heads ``(5,10,10,20)``,
``cross_attention_dim=1024``; sinusoid->MLP timestep embedding plus the
(fps, motion_bucket_id, noise_aug) micro-conditioning; ControlNet residual
injection after the down path and the mid block.

I/O layout: ``sample [B, F, H, W, C]`` channels-last, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..utils import profiling
from .layers import GroupNorm, TimestepEmbedding, sinusoidal_embedding
from .resnet import Conv2d
from .unet_blocks import (CrossAttnDownBlockSpatioTemporal, CrossAttnUpBlockSpatioTemporal,
                          DownBlockSpatioTemporal, UNetMidBlockSpatioTemporal,
                          UpBlockSpatioTemporal)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 10, 20)
    remat: bool = False  # per-block activation checkpointing (training)

    @staticmethod
    def tiny(remat: bool = False):
        """Same topology, few channels (the JAX ``UNetConfig.tiny()``)."""
        return UNetConfig(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 2, 2, 4),
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            remat=remat,
        )

    @staticmethod
    def nano(remat: bool = False):
        """2-block topology (the JAX ``UNetConfig.nano()``): one cross-attn
        down block and one plain block, mirrored on the way up."""
        return UNetConfig(
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"),
            block_out_channels=(32, 32),
            num_attention_heads=(2, 2),
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            remat=remat,
        )


def call_block(name: str, remat: bool, block, *args):
    """``block(*args)``; under ``remat`` with autograd recording, through
    ``torch.utils.checkpoint`` (the JAX ``nn.remat`` of each block, the
    reference's per-block gradient checkpointing): the block's activations
    are dropped after the forward and recomputed in the backward.  ``name``
    (the block's qualified name, ``unet.up_blocks.3``) scopes its operations
    in a profile of an eager step; a replayed graph runs no such scope."""
    with profiling.annotate(name):
        if remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)


def up_block_in_channels(channels: Sequence[int], layers_per_block: int):
    """(previous + skip) input widths of each up block's resnets."""
    rev = list(reversed(channels))
    out, prev = [], rev[0]
    for i, cout in enumerate(rev):
        cins = []
        for j in range(layers_per_block + 1):
            skip = rev[min(i + 1, len(rev) - 1)] if j == layers_per_block else cout
            cins.append((prev if j == 0 else cout) + skip)
        out.append(cins)
        prev = cout
    return out


def build_down_blocks(cfg, temb_dim: int) -> nn.ModuleList:
    blocks, cin = [], cfg.block_out_channels[0]
    for i, (kind, c) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
        last = i == len(cfg.block_out_channels) - 1
        if kind == "CrossAttnDownBlockSpatioTemporal":
            blocks.append(CrossAttnDownBlockSpatioTemporal(
                cin, c, temb_dim, cfg.num_attention_heads[i], cfg.layers_per_block,
                cfg.transformer_layers_per_block, cfg.cross_attention_dim,
                add_downsample=not last))
        else:
            blocks.append(DownBlockSpatioTemporal(cin, c, temb_dim, cfg.layers_per_block,
                                                  add_downsample=not last))
        cin = c
    return nn.ModuleList(blocks)


def run_down_blocks(blocks, x, temb, context, indicator, context_clips, remat=False,
                    prefix: str = "unet"):
    down_res = [x]
    for i, blk in enumerate(blocks):
        name = f"{prefix}.down_blocks.{i}"
        if isinstance(blk, CrossAttnDownBlockSpatioTemporal):
            x, states = call_block(name, remat, blk, x, temb, context, indicator, context_clips)
        else:
            x, states = call_block(name, remat, blk, x, temb, indicator)
        down_res += states
    return x, down_res


def embed_time(model, timestep, added_time_ids, b: int, dtype):
    """Timestep + micro-conditioning embedding ``[B, temb]``."""
    ch0 = model.config.block_out_channels[0]
    dev = added_time_ids.device
    t = torch.as_tensor(timestep, dtype=torch.float32, device=dev).reshape(-1)
    t = t.expand(b) if t.numel() == 1 else t
    emb = model.time_embedding(sinusoidal_embedding(t, ch0).to(dtype))
    time_embeds = sinusoidal_embedding(added_time_ids.reshape(-1),
                                       model.config.addition_time_embed_dim)
    return emb + model.add_embedding(time_embeds.reshape(b, -1).to(dtype))


class UNetSpatioTemporalConditionModel(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = build_down_blocks(cfg, temb)
        self.mid_block = UNetMidBlockSpatioTemporal(
            ch[-1], temb, cfg.num_attention_heads[-1], cfg.transformer_layers_per_block,
            cfg.cross_attention_dim)
        rev_ch = list(reversed(ch))
        rev_heads = list(reversed(cfg.num_attention_heads))
        cins = up_block_in_channels(ch, cfg.layers_per_block)
        ups = []
        for i, kind in enumerate(cfg.up_block_types):
            last = i == len(ch) - 1
            if kind == "CrossAttnUpBlockSpatioTemporal":
                ups.append(CrossAttnUpBlockSpatioTemporal(
                    cins[i], rev_ch[i], temb, rev_heads[i], cfg.transformer_layers_per_block,
                    cfg.cross_attention_dim, add_upsample=not last))
            else:
                ups.append(UpBlockSpatioTemporal(cins[i], rev_ch[i], temb,
                                                 add_upsample=not last))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(32, ch[0], 1e-5, with_silu=True)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3)

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                context_clips: int = 1):
        """sample [B, F, H, W, C_in]; timestep scalar or [B]; encoder states
        [B, S, D]; added_time_ids [B, 3] -> [B, F, H, W, C_out]."""
        dtype = self.conv_in.weight.dtype
        b, f = sample.shape[:2]
        with profiling.annotate("unet.embedding"):
            emb = embed_time(self, timestep, added_time_ids, b, dtype)
            temb = emb[:, None, :].expand(b, f, emb.shape[-1])
            context = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)
            indicator = torch.zeros((b, f), dtype=dtype, device=sample.device)

        with profiling.annotate("unet.conv_in"):
            x = sample.to(dtype)
            x = self.conv_in(x.reshape(b * f, *x.shape[2:])).reshape(b, f, *x.shape[2:4], -1)
        remat = self.config.remat
        x, down_res = run_down_blocks(self.down_blocks, x, temb, context, indicator,
                                      context_clips, remat)

        # a ControlNet's residuals may come in another dtype (an fp32
        # GestureNet over a bf16 UNet): each sum is rounded to the UNet's
        # dtype, where the JAX UNet's next layer casts it
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(down_res):
                raise ValueError(
                    f"ControlNet produced {len(down_block_additional_residuals)} "
                    f"residuals but the UNet has {len(down_res)} skip states — "
                    f"mismatched UNet/ControlNet configs")
            with profiling.annotate("unet.add_residuals"):
                down_res = [(r + a).to(dtype)
                            for r, a in zip(down_res, down_block_additional_residuals)]

        x = call_block("unet.mid_block", remat, self.mid_block, x, temb, context, indicator,
                       context_clips)
        if mid_block_additional_residual is not None:
            with profiling.annotate("unet.add_residuals"):
                x = (x + mid_block_additional_residual).to(dtype)

        n_res = self.config.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            res, down_res = down_res[-n_res:], down_res[:-n_res]
            name = f"unet.up_blocks.{i}"
            if isinstance(blk, CrossAttnUpBlockSpatioTemporal):
                x = call_block(name, remat, blk, x, res, temb, context, indicator, context_clips)
            else:
                x = call_block(name, remat, blk, x, res, temb, indicator)

        with profiling.annotate("unet.conv_norm_out"):
            flat = self.conv_norm_out(x.reshape(b * f, *x.shape[2:]))
        with profiling.annotate("unet.conv_out"):
            flat = self.conv_out(flat)
            return flat.reshape(b, f, *flat.shape[1:])
