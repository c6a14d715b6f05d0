"""Spatio-temporal residual blocks (counterpart of ``models/resnet.py``).

Block layout: ``[B, F, H, W, C]`` channels-last.  Spatial convolutions fold
frames into batch; the (3,1,1) temporal convolution is one cuDNN conv with a
(3, 1) kernel over the ``[B, F, H*W, C]`` view (frames as height), with the
HF weight ``[O, I, 3, 1, 1]`` viewed as ``[O, I, 3, 1]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import AlphaBlender, GroupNorm


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on channels-last ``[N, H, W, C]`` input.  The permuted
    view is an NCHW tensor in ``channels_last`` memory format, which cuDNN
    consumes and produces without a copy; the result is permuted back."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True, groups: int = 1):
        pad = (kernel_size - 1) // 2 if padding is None else padding
        super().__init__(cin, cout, kernel_size, stride=stride, padding=pad, bias=bias,
                         groups=groups)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


class TemporalConv3(nn.Module):
    """(3,1,1) temporal conv on ``[B, F, H, W, C]`` (HF ``Conv3d`` weight)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        b, f, h, w, c = x.shape
        xv = x.reshape(b, f, h * w, c).permute(0, 3, 1, 2)  # [B, C, F, HW] channels_last
        out = F.conv2d(xv, self.weight[..., 0], self.bias, padding=(1, 0))
        return out.permute(0, 2, 3, 1).reshape(b, f, h, w, -1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+temb) -> GN -> SiLU -> conv -> +shortcut."""

    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps, with_silu=True)
        self.conv1 = Conv2d(cin, cout, 3)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(32, cout, eps, with_silu=True)
        self.conv2 = Conv2d(cout, cout, 3)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """Temporal twin of ResnetBlock2D with (3,1,1) convs over frames; the
    GroupNorm statistics span frames (rank-5 torch parity)."""

    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps, with_silu=True)
        self.conv1 = TemporalConv3(cin, cout)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(32, cout, eps, with_silu=True)
        self.conv2 = TemporalConv3(cout, cout)
        if cin != cout:
            self.conv_shortcut = nn.Linear(cin, cout)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """Spatial resblock + temporal resblock merged by a learned AlphaBlender."""

    def __init__(self, cin: int, cout: int, temb_dim: Optional[int], eps: float = 1e-5,
                 temporal_eps: Optional[float] = None,
                 merge_strategy: str = "learned_with_images",
                 switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_dim, eps)
        self.temporal_res_block = TemporalResnetBlock(
            cout, cout, temb_dim, temporal_eps if temporal_eps is not None else eps)
        self.time_mixer = AlphaBlender(merge_strategy, switch_spatial_to_temporal_mix)

    def forward(self, x, temb=None, image_only_indicator=None):
        b, f, hh, ww, c = x.shape
        temb_flat = None if temb is None else temb.reshape(b * f, -1)
        h = self.spatial_res_block(x.reshape(b * f, hh, ww, c), temb_flat)
        h = h.reshape(b, f, hh, ww, -1)
        h_t = self.temporal_res_block(h, temb)
        return self.time_mixer(h, h_t, image_only_indicator)


class Downsample2D(nn.Module):
    """Strided 3x3 conv, pad 1 (HF key ``downsamplers.N.conv``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3)

    def forward(self, x):
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        return self.conv(up.permute(0, 2, 3, 1))
