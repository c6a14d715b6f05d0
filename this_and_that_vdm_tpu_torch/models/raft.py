"""RAFT optical flow (counterpart of ``models/raft.py``), fp32, eval only.

The trajectory stage of curation and the motion statistics run on dense
flow.  RAFT (Teed & Deng, ECCV 2020), the "large" model of princeton-vl,
with the state-dict names of its published checkpoints (``raft-things.pth``
and kin, ``module.`` prefix stripped), so a file loads with
``load_state_dict(strict=True)``:

  * ``fnet``: residual CNN with instance norm (no parameters), 1/8
    resolution, shared by both frames; ``cnet``: the same with eval-mode
    batch norm, split into the GRU state (tanh) and context (relu);
  * the all-pairs correlation, an average-pooled pyramid, and a bilinear
    lookup of a (2r+1)^2 window around the current flow, in the reference's
    transposed window order (``lookup_corr``);
  * the update block (motion encoder, separable ConvGRU, flow head, convex
    upsampling mask), iterated in a plain loop; only the last mask is used.

Images go in as ``[B, H, W, 3]`` in [0, 255] (H, W multiples of 8); flow
comes out as ``[B, H, W, 2]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .frozen_bn import FrozenBatchNorm2d


@dataclass(frozen=True)
class RAFTConfig:
    enc_dims: Tuple[int, int, int, int] = (64, 64, 96, 128)  # stem, layer1-3
    fdim: int = 256       # fnet output dim
    hdim: int = 128       # GRU hidden dim
    cdim: int = 128       # context dim
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12       # update iterations (the official demos use 20)
    me_c1: int = 256      # motion-encoder widths (convc1/convc2/convf1/convf2)
    me_c2: int = 192
    me_f1: int = 128
    me_f2: int = 64
    motion_dim: int = 128  # motion feature dim (conv emits motion_dim-2 + flow)
    fh_dim: int = 256      # flow-head hidden
    mask_dim: int = 256    # upsample-mask-head hidden

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @classmethod
    def large(cls) -> "RAFTConfig":
        """Checkpoint-compatible raft-things/sintel/kitti config."""
        return cls()

    @classmethod
    def tiny(cls) -> "RAFTConfig":
        """Test-size config (same topology, ~1000x fewer FLOPs)."""
        return cls(enc_dims=(8, 8, 12, 16), fdim=16, hdim=16, cdim=16, corr_levels=2,
                   corr_radius=2, iters=3, me_c1=24, me_c2=16, me_f1=12, me_f2=8,
                   motion_dim=16, fh_dim=16, mask_dim=16)

    @classmethod
    def from_state_dict(cls, sd, corr_levels: int = 4) -> "RAFTConfig":
        """Infer every width from an official checkpoint's shapes."""
        def shape(k):
            return np.shape(sd[k])

        d0 = shape("fnet.conv1.weight")[0]
        d1 = shape("fnet.layer1.0.conv1.weight")[0]
        d2 = shape("fnet.layer2.0.conv1.weight")[0]
        d3 = shape("fnet.layer3.0.conv1.weight")[0]
        hdim = shape("update_block.flow_head.conv1.weight")[1]
        k2 = shape("update_block.encoder.convc1.weight")[1] // corr_levels
        return cls(enc_dims=(d0, d1, d2, d3), fdim=shape("fnet.conv2.weight")[0], hdim=hdim,
                   cdim=shape("cnet.conv2.weight")[0] - hdim, corr_levels=corr_levels,
                   corr_radius=(int(round(k2 ** 0.5)) - 1) // 2,
                   me_c1=shape("update_block.encoder.convc1.weight")[0],
                   me_c2=shape("update_block.encoder.convc2.weight")[0],
                   me_f1=shape("update_block.encoder.convf1.weight")[0],
                   me_f2=shape("update_block.encoder.convf2.weight")[0],
                   motion_dim=shape("update_block.encoder.conv.weight")[0] + 2,
                   fh_dim=shape("update_block.flow_head.conv1.weight")[0],
                   mask_dim=shape("update_block.mask.0.weight")[0])


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d`` defaults: per sample and channel over H, W,
    biased variance, eps 1e-5, no parameters (fnet's norms hold no state)."""

    def forward(self, x):
        mean = x.mean((2, 3), keepdim=True)
        var = x.var((2, 3), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def _norm(kind: str, c: int) -> nn.Module:
    return FrozenBatchNorm2d(c) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    """Two 3x3 convs (norm + relu after each), a 1x1 strided shortcut when
    the stride is not 1.  As in the official code, ``norm3`` is registered
    twice (itself and ``downsample.1``), so checkpoints carry both names."""

    def __init__(self, cin: int, planes: int, norm: str, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7 stride-2 stem, three 2-block stages to 1/8 resolution, 1x1 out."""

    def __init__(self, cfg: RAFTConfig, out_dim: int, norm: str):
        super().__init__()
        d0, d1, d2, d3 = cfg.enc_dims
        self.conv1 = nn.Conv2d(3, d0, 7, 2, 3)
        self.norm1 = _norm(norm, d0)
        self.layer1 = nn.Sequential(ResidualBlock(d0, d1, norm, 1), ResidualBlock(d1, d1, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(d1, d2, norm, 2), ResidualBlock(d2, d2, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(d2, d3, norm, 2), ResidualBlock(d3, d3, norm, 1))
        self.conv2 = nn.Conv2d(d3, out_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.convc1 = nn.Conv2d(cfg.corr_planes, cfg.me_c1, 1)
        self.convc2 = nn.Conv2d(cfg.me_c1, cfg.me_c2, 3, padding=1)
        self.convf1 = nn.Conv2d(2, cfg.me_f1, 7, padding=3)
        self.convf2 = nn.Conv2d(cfg.me_f1, cfg.me_f2, 3, padding=1)
        self.conv = nn.Conv2d(cfg.me_c2 + cfg.me_f2, cfg.motion_dim - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], 1))), flow], 1)


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a horizontal (1x5) pass, then a vertical (5x1)."""

    def __init__(self, hidden: int, inp: int):
        super().__init__()
        c = hidden + inp
        for s, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", nn.Conv2d(c, hidden, k, padding=p))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """One iteration: motion encode -> GRU -> (delta flow, upsampling mask)."""

    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg)
        self.gru = SepConvGRU(cfg.hdim, cfg.cdim + cfg.motion_dim)
        self.flow_head = FlowHead(cfg.hdim, cfg.fh_dim)
        self.mask = nn.Sequential(nn.Conv2d(cfg.hdim, cfg.mask_dim, 3, padding=1),
                                  nn.ReLU(inplace=True), nn.Conv2d(cfg.mask_dim, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(cfg, cfg.fdim, "instance")
        self.cnet = BasicEncoder(cfg, cfg.hdim + cfg.cdim, "batch")
        self.update_block = BasicUpdateBlock(cfg)

    def forward(self, image1, image2, iters: int = 0):
        """images [B, H, W, 3] in [0, 255] -> (flow_low [B, H/8, W/8, 2],
        flow_up [B, H, W, 2])."""
        cfg = self.cfg
        x1 = 2.0 * (image1.permute(0, 3, 1, 2) / 255.0) - 1.0
        x2 = 2.0 * (image2.permute(0, 3, 1, 2) / 255.0) - 1.0
        f1, f2 = self.fnet(torch.cat([x1, x2], 0)).chunk(2)
        c = self.cnet(x1)
        net, inp = torch.tanh(c[:, :cfg.hdim]), F.relu(c[:, cfg.hdim:])
        pyramid = build_corr_pyramid(f1, f2, cfg.corr_levels)
        b, _, h8, w8 = f1.shape
        coords0 = coords_grid(b, h8, w8, f1.device)
        coords1 = coords0
        mask = None
        for _ in range(iters or cfg.iters):
            corr = lookup_corr(pyramid, coords1, cfg.corr_radius)
            net, mask, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        flow_low = coords1 - coords0
        flow_up = upsample_flow_convex(flow_low, mask)
        return flow_low.permute(0, 2, 3, 1), flow_up.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Parameter-free correlation and upsampling
# --------------------------------------------------------------------------


def build_corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, num_levels: int):
    """All-pairs correlation over sqrt(D), average-pooled.  Per level
    ``[B*H*W, H/2^i, W/2^i]``: each query pixel owns a correlation image."""
    b, d, h, w = f1.shape
    corr = torch.bmm(f1.reshape(b, d, h * w).transpose(1, 2), f2.reshape(b, d, h * w))
    corr = (corr / torch.sqrt(corr.new_tensor(float(d)))).reshape(b * h * w, 1, h, w)
    pyramid = [corr[:, 0]]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyramid.append(corr[:, 0])
    return pyramid


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(align_corners=True, padding_mode='zeros')`` in pixel
    coordinates: img [N, H, W], coords [N, K, 2] (x, y) -> [N, K].  Written
    with gathers, so a level one pixel wide samples without dividing by 0."""
    n, h, w = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(n, h * w)
    out = 0.0
    for xi, wx in ((x0, x0 + 1 - x), (x0 + 1, x - x0)):
        for yi, wy in ((y0, y0 + 1 - y), (y0 + 1, y - y0)):
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            out = out + torch.gather(flat, 1, idx) * (wx * wy * valid)
    return out


def lookup_corr(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int):
    """Sample a (2r+1)^2 window around coords / 2^i at every level.
    coords [B, 2, H, W] (x, y) -> [B, levels*(2r+1)^2, H, W].

    The window's channel order is the reference CorrBlock's: its offsets are
    ``stack(meshgrid(dy, dx), -1)``, whose first component (added to x)
    varies along the window's row axis, the transpose of the natural order.
    A checkpoint's ``convc1`` expects exactly this order."""
    b, _, h, w = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    off = torch.stack([oy.reshape(-1), ox.reshape(-1)], -1)  # [(2r+1)^2, 2]
    flat = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2)
    out = [bilinear_sample(corr, flat / 2.0 ** i + off[None]).reshape(b, h, w, -1)
           for i, corr in enumerate(pyramid)]
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def coords_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """[B, 2, H, W] pixel grid, (x, y) channel order."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys])[None].expand(b, 2, h, w)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x upsampling: a convex combination of the 3x3 neighbourhood of
    8*flow under the softmax(9)-normalised mask.  flow [B, 2, H, W], mask
    [B, 64*9, H, W] -> [B, 2, 8H, 8W]."""
    b, _, h, w = flow.shape
    m = mask.view(b, 1, 9, 8, 8, h, w).softmax(2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).view(b, 2, 9, 1, 1, h, w)
    up = (m * up).sum(2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 2, 8 * h, 8 * w)


def pad_to_multiple(img: np.ndarray, multiple: int = 8):
    """Sintel-style InputPadder (left/right split, top-heavy vertical),
    replicate padding.  img [H, W, C] -> (padded, (top, left, H, W))."""
    h, w = img.shape[:2]
    ph, pw = (-h) % multiple, (-w) % multiple
    top, left = ph // 2, pw // 2
    out = np.pad(img, ((top, ph - top), (left, pw - left), (0, 0)), mode="edge")
    return out, (top, left, h, w)
