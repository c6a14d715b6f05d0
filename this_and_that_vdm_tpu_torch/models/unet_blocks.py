"""Down/mid/up blocks of the spatio-temporal UNet (counterpart of
``models/unet_blocks.py``).

Eps quirks of the reference kept (PARITY.md quirk 3): cross-attention down
blocks build resblocks with eps=1e-6, plain down blocks and the mid block
with 1e-5, and BOTH up-block types with 1e-6 (get_up_block never forwards
the UNet's resnet_eps into the SpatioTemporal branches).

Block I/O: ``x [B, F, H, W, C]``, ``temb [B, F, temb_dim]``,
``context [B*F, S, D]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .resnet import Downsample2D, SpatioTemporalResBlock, Upsample2D
from .transformer import TransformerSpatioTemporalModel


def _per_frame(module, x):
    """Apply a 2-D module to ``[B, F, H, W, C]`` with frames folded into batch."""
    b, f = x.shape[:2]
    y = module(x.reshape(b * f, *x.shape[2:]))
    return y.reshape(b, f, *y.shape[1:])


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, num_layers: int = 2,
                 add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout, temb_dim, eps=1e-5)
            for i in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])

    def forward(self, x, temb, image_only_indicator):
        states = []
        for r in self.resnets:
            x = r(x, temb, image_only_indicator)
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = _per_frame(self.downsamplers[0], x)
            states.append(x)
        return x, states


class CrossAttnDownBlockSpatioTemporal(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: int, heads: int,
                 num_layers: int = 2, transformer_layers: int = 1,
                 cross_attention_dim: int = 1024, add_downsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(cin if i == 0 else cout, cout, temb_dim, eps=1e-6)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(cout, heads, cout // heads, transformer_layers,
                                           cross_attention_dim)
            for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])

    def forward(self, x, temb, context, image_only_indicator, context_clips=1):
        states = []
        for r, a in zip(self.resnets, self.attentions):
            x = r(x, temb, image_only_indicator)
            x = a(x, context, image_only_indicator, context_clips)
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = _per_frame(self.downsamplers[0], x)
            states.append(x)
        return x, states


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, c: int, temb_dim: int, heads: int, transformer_layers: int = 1,
                 cross_attention_dim: int = 1024):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(c, c, temb_dim, eps=1e-5) for _ in range(2)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(c, heads, c // heads, transformer_layers,
                                           cross_attention_dim)])

    def forward(self, x, temb, context, image_only_indicator, context_clips=1):
        x = self.resnets[0](x, temb, image_only_indicator)
        x = self.attentions[0](x, context, image_only_indicator, context_clips)
        return self.resnets[1](x, temb, image_only_indicator)


class UpBlockSpatioTemporal(nn.Module):
    def __init__(self, cins: Sequence[int], cout: int, temb_dim: int,
                 add_upsample: bool = True):
        super().__init__()
        # eps=1e-6: get_up_block drops resnet_eps for the SpatioTemporal branches
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ci, cout, temb_dim, eps=1e-6) for ci in cins])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x, res_states, temb, image_only_indicator):
        res_states = list(res_states)
        for r in self.resnets:
            x = torch.cat([x, res_states.pop()], dim=-1)
            x = r(x, temb, image_only_indicator)
        if hasattr(self, "upsamplers"):
            x = _per_frame(self.upsamplers[0], x)
        return x


class CrossAttnUpBlockSpatioTemporal(nn.Module):
    def __init__(self, cins: Sequence[int], cout: int, temb_dim: int, heads: int,
                 transformer_layers: int = 1, cross_attention_dim: int = 1024,
                 add_upsample: bool = True):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ci, cout, temb_dim, eps=1e-6) for ci in cins])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(cout, heads, cout // heads, transformer_layers,
                                           cross_attention_dim)
            for _ in cins])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x, res_states, temb, context, image_only_indicator,
                context_clips: Optional[int] = 1):
        res_states = list(res_states)
        for r, a in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_states.pop()], dim=-1)
            x = r(x, temb, image_only_indicator)
            x = a(x, context, image_only_indicator, context_clips)
        if hasattr(self, "upsamplers"):
            x = _per_frame(self.upsamplers[0], x)
        return x
