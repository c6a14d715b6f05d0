"""GestureNet — temporal ControlNet over the SVD UNet encoder (counterpart of
``models/controlnet.py``).

A copy of the UNet's down/mid path with ``conv_in_concat`` (12 -> ch0 over
``cat(noisy+cond latents [8], VAE(gesture raster) [4])``), 1x1 zero convs on
every skip state and on the mid output, heads ``(5,10,20,20)`` (index 2
differs from the UNet's), and output scaling by ``conditioning_scale`` or
the ``guess_mode`` logspace 0.1 -> 1.0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils import profiling
from .layers import TimestepEmbedding
from .resnet import Conv2d
from .unet import build_down_blocks, call_block, embed_time, run_down_blocks
from .unet_blocks import UNetMidBlockSpatioTemporal


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    in_channels: int = 8
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    remat: bool = False  # per-block activation checkpointing (training)

    @staticmethod
    def tiny(remat: bool = False):
        return ControlNetConfig(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 2, 4, 4),
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            remat=remat,
        )

    @staticmethod
    def nano(remat: bool = False):
        """2-block companion of ``UNetConfig.nano()``."""
        return ControlNetConfig(
            down_block_types=("CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"),
            block_out_channels=(32, 32),
            num_attention_heads=(2, 2),
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            remat=remat,
        )


class ControlNetModel(nn.Module):
    def __init__(self, config: ControlNetConfig = ControlNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        # + the 4 VAE latent channels of the gesture raster
        self.conv_in_concat = Conv2d(cfg.in_channels + 4, ch[0], 3)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = build_down_blocks(cfg, temb)
        self.mid_block = UNetMidBlockSpatioTemporal(
            ch[-1], temb, cfg.num_attention_heads[-1], cfg.transformer_layers_per_block,
            cfg.cross_attention_dim)
        widths = [ch[0]]
        for i, c in enumerate(ch):
            widths += [c] * (cfg.layers_per_block + (i < len(ch) - 1))
        self.controlnet_down_blocks = nn.ModuleList([Conv2d(c, c, 1) for c in widths])
        self.controlnet_mid_block = Conv2d(ch[-1], ch[-1], 1)

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                controlnet_cond, conditioning_scale=1.0, guess_mode: bool = False,
                context_clips: int = 1):
        """sample [B, F, H, W, 8]; controlnet_cond [B, F, H, W, 4] (VAE-encoded
        gestures) -> (tuple of skip residuals, mid residual).
        ``conditioning_scale``: a float, or a 0-dim tensor on the sample's
        device (the denoise loop's per-step table, read inside a captured
        step without a host copy)."""
        dtype = self.conv_in_concat.weight.dtype
        b, f = sample.shape[:2]
        with profiling.annotate("controlnet.embedding"):
            emb = embed_time(self, timestep, added_time_ids, b, dtype)
            temb = emb[:, None, :].expand(b, f, emb.shape[-1])
            context = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)
            indicator = torch.zeros((b, f), dtype=dtype, device=sample.device)

        with profiling.annotate("controlnet.conv_in"):
            x = torch.cat([sample.to(dtype), controlnet_cond.to(dtype)], dim=-1)
            x = self.conv_in_concat(x.reshape(b * f, *x.shape[2:])).reshape(
                b, f, *x.shape[2:4], -1)
        x, down_res = run_down_blocks(self.down_blocks, x, temb, context, indicator,
                                      context_clips, self.config.remat, prefix="controlnet")
        x = call_block("controlnet.mid_block", self.config.remat, self.mid_block, x, temb,
                       context, indicator, context_clips)

        with profiling.annotate("controlnet.conv_out"):  # the zero convs, scaled
            ctrl = []
            for conv, r in zip(self.controlnet_down_blocks, down_res):
                ctrl.append(conv(r.reshape(b * f, *r.shape[2:])).reshape(r.shape))
            mid = self.controlnet_mid_block(x.reshape(b * f, *x.shape[2:])).reshape(x.shape)

            if guess_mode:
                scales = np.logspace(-1, 0, len(ctrl) + 1)  # 0.1 .. 1.0
                ctrl = [r * float(s) * conditioning_scale for r, s in zip(ctrl, scales)]
                mid = mid * float(scales[-1]) * conditioning_scale
            else:
                ctrl = [r * conditioning_scale for r in ctrl]
                mid = mid * conditioning_scale
            return tuple(ctrl), mid
