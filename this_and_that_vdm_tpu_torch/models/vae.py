"""AutoencoderKLTemporalDecoder — SVD's VAE (counterpart of ``models/vae.py``).

Plain 2D KL encoder; temporal decoder of SpatioTemporalResBlocks with
``merge_strategy='learned'`` + ``switch_spatial_to_temporal_mix`` and no
temb, a single-head attention mid block, and a final (3,1,1) temporal conv
over RGB.  Encoder takes ``[N, H, W, 3]``; decoder takes ``[B, F, h, w, 4]``
and returns ``[B, F, H, W, 3]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import GroupNorm
from .resnet import Conv2d, SpatioTemporalResBlock, TemporalConv3, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny():
        return VAEConfig(block_out_channels=(32, 32, 64, 64), scaling_factor=0.18215)


class ResnetBlock2DNoTemb(nn.Module):
    """VAE resblock: GN(eps 1e-6) -> SiLU -> conv, twice, + shortcut."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, 1e-6, with_silu=True)
        self.conv1 = Conv2d(cin, cout, 3)
        self.norm2 = GroupNorm(32, cout, 1e-6, with_silu=True)
        self.conv2 = Conv2d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head attention over H*W with GroupNorm + residual."""

    def __init__(self, c: int):
        super().__init__()
        self.group_norm = GroupNorm(32, c, 1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, c)
        q, k, v = (m(t)[:, :, None, :] for m in (self.to_q, self.to_k, self.to_v))
        o = dot_product_attention(q, k, v)[:, :, 0, :]
        return self.to_out[0](o).reshape(n, h, w, c) + x


class EncoderDownsample(nn.Module):
    """Pad (0,1) right/bottom, then a stride-2 VALID conv (key ``.conv``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Block(nn.Module):
    """Container with HF sub-keys ``resnets`` / ``attentions`` / samplers."""


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(3, ch[0], 3)
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            blk = _Block()
            blk.resnets = nn.ModuleList([ResnetBlock2DNoTemb(cin if j == 0 else c, c)
                                         for j in range(cfg.layers_per_block)])
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([EncoderDownsample(c)])
            blocks.append(blk)
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2DNoTemb(ch[-1], ch[-1])
                                                for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch[-1])])
        self.conv_norm_out = GroupNorm(32, ch[-1], 1e-6, with_silu=True)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        return self.conv_out(self.conv_norm_out(h))


def _st_block(cin: int, cout: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                  merge_strategy="learned",
                                  switch_spatial_to_temporal_mix=True)


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        top = ch[-1]
        self.conv_in = Conv2d(cfg.latent_channels, top, 3)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([_st_block(top, top) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(top)])
        rev = list(reversed(ch))
        ups, prev = [], top
        for i, c in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([_st_block(prev if j == 0 else c, c)
                                         for j in range(cfg.layers_per_block + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c)])
            ups.append(blk)
            prev = c
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(32, ch[0], 1e-6, with_silu=True)
        self.conv_out = Conv2d(ch[0], 3, 3)
        self.time_conv_out = TemporalConv3(3, 3)

    def forward(self, z):
        b, f = z.shape[:2]

        def per_frame(fn, h):
            y = fn(h.reshape(b * f, *h.shape[2:]))
            return y.reshape(b, f, *y.shape[1:])

        h = per_frame(self.conv_in, z)
        mid = self.mid_block
        h = mid.resnets[0](h)
        h = per_frame(mid.attentions[0], h)
        h = mid.resnets[1](h)
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = per_frame(blk.upsamplers[0], h)
        h = per_frame(lambda t: self.conv_out(self.conv_norm_out(t)), h)
        return self.time_conv_out(h)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = TemporalDecoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)

    def encode_mode(self, x):
        """Posterior mean (``latent_dist.mode()``): ``x`` [N, H, W, 3] in
        [-1, 1] -> [N, H/8, W/8, 4]."""
        x = x.to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x))
        return moments[..., : self.config.latent_channels].contiguous()

    def decode(self, z):
        """``z`` [B, F, h, w, 4] (already / scaling_factor) -> [B, F, H, W, 3]."""
        return self.decoder(z.to(self.quant_conv.weight.dtype))
