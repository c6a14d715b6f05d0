"""The reference models: SVD's spatio-temporal UNet, the GestureNet
ControlNet, the temporal VAE and the two CLIP towers, in plain PyTorch.

Written from the published architectures (diffusers
``UNetSpatioTemporalConditionModel``, ``ControlNetModel`` of This&That's
``svd/gesturenet``, ``AutoencoderKLTemporalDecoder``, transformers
``CLIPVisionModelWithProjection`` / ``CLIPTextModel``), with the HF
state-dict keys, so one state dict loads here and into the measured program.
Tensors are channels-last (``[B, F, H, W, C]``).  Everything is computed in
fp32 through ``ops``; no fused kernel, no cache, no graph.

Two behaviours of the This&That code base are kept on purpose, because the
system reproduces them: the eps of the resnets (1e-6 in cross-attention down
blocks and in every up block, 1e-5 elsewhere), and the temporal
cross-attention's context, broadcast hw-major, so that row ``r`` of the
folded ``[B * H * W, F, C]`` batch reads context ``r % B``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ops


# --------------------------------------------------------------- primitives

class Linear(nn.Linear):
    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    """Channels-last 2-D convolution, padding (k - 1) // 2 unless given."""

    def __init__(self, cin, cout, k=3, stride=1, padding=None, bias=True):
        super().__init__(cin, cout, k, stride=stride, bias=bias,
                         padding=(k - 1) // 2 if padding is None else padding)

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride[0], self.padding[0])


class TemporalConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return ops.temporal_conv(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, c, eps, silu=False, groups=32):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(c)), nn.Parameter(torch.empty(c))
        self.eps, self.silu, self.groups = eps, silu, groups

    def forward(self, x):
        return ops.group_norm(x, self.weight, self.bias, self.groups, self.eps, self.silu)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.weight, self.bias = nn.Parameter(torch.empty(c)), nn.Parameter(torch.empty(c))
        self.eps = eps

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.eps)

    def project(self, x, lin: nn.Linear):
        return ops.ln_linear(x, self.weight, self.bias, self.eps, lin.weight, lin.bias)


def sinusoid(t, dim, max_period=10000.0):
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, shift=0)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                          device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim, out=None):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, dim), Linear(dim, out or dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """sigmoid(mix_factor) * spatial + (1 - it) * temporal; ``switch`` swaps
    the two (the VAE decoder's blocks)."""

    def __init__(self, switch=False):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1))
        self.switch = switch

    def forward(self, spatial, temporal):
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * spatial + (1.0 - alpha) * temporal


# ------------------------------------------------------------------ resnets

class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb, eps):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin, eps, True), Conv(cin, cout)
        if temb:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2, self.conv2 = GroupNorm(cout, eps, True), Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x, temb=None):  # x [N, H, W, C], temb [N, T]
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None]
        h = self.conv2(self.norm2(h))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class TemporalResnetBlock(nn.Module):
    def __init__(self, c, temb, eps):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(c, eps, True), TemporalConv(c, c)
        if temb:
            self.time_emb_proj = Linear(temb, c)
        self.norm2, self.conv2 = GroupNorm(c, eps, True), TemporalConv(c, c)

    def forward(self, x, temb=None):  # x [B, F, H, W, C], temb [B, F, T]
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        return x + self.conv2(self.norm2(h))


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin, cout, temb, eps, temporal_eps=None, switch=False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps)
        self.temporal_res_block = TemporalResnetBlock(
            cout, temb, eps if temporal_eps is None else temporal_eps)
        self.time_mixer = AlphaBlender(switch)

    def forward(self, x, temb=None):
        b, f = x.shape[:2]
        h = self.spatial_res_block(x.flatten(0, 1), None if temb is None else temb.flatten(0, 1))
        h = h.reshape(b, f, *h.shape[1:])
        return self.time_mixer(h, self.temporal_res_block(h, temb))


def per_frame(fn, x):
    b, f = x.shape[:2]
    y = fn(x.flatten(0, 1))
    return y.reshape(b, f, *y.shape[1:])


class Downsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


# -------------------------------------------------------------- transformer

class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim or dim, inner, bias=False)
        self.to_v = Linear(ctx_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, ln: LayerNorm, context=None):
        if context is None:  # one projection of the normalised rows to q, k and v
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            q, k, v = ops.ln_linear(x, ln.weight, ln.bias, ln.eps, w).chunk(3, dim=-1)
        else:
            q = ln.project(x, self.to_q)
            k, v = self.to_k(context), self.to_v(context)
        split = lambda t: t.reshape(*t.shape[:2], self.heads, -1)  # noqa: E731
        out = ops.attention(split(q), split(k), split(v))
        return self.to_out[0](out.flatten(2))


class GroupedCrossAttention(Attention):
    """The temporal blocks' cross-attention: rows ``[R, F, C]`` against
    ``n`` contexts, row ``r`` reading context ``r % n``."""

    def forward(self, x, ln: LayerNorm, context=None):
        r, f, _ = x.shape
        n = context.shape[0]
        q = ln.project(x, self.to_q).reshape(r // n, n, f, self.heads, -1)
        k = self.to_k(context).reshape(n, -1, self.heads, q.shape[-1])
        v = self.to_v(context).reshape(n, -1, self.heads, q.shape[-1])
        logits = torch.einsum("mnfhd,nkhd->mnhfk", ops._q(q), ops._q(k)) * q.shape[-1] ** -0.5
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("mnhfk,nkhd->mnfhd", ops._q(probs), ops._q(v))
        return self.to_out[0](out.reshape(r, f, -1))


class _GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x, ln: LayerNorm):
        h, gate = ln.project(x, self.net[0].proj).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim):
        super().__init__()
        self.norm1, self.attn1 = LayerNorm(dim), Attention(dim, heads, dim_head)
        self.norm2, self.attn2 = LayerNorm(dim), Attention(dim, heads, dim_head, ctx_dim)
        self.norm3, self.ff = LayerNorm(dim), FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(x, self.norm1)
        x = x + self.attn2(x, self.norm2, context)
        return x + self.ff(x, self.norm3)


class TemporalBasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, ctx_dim):
        super().__init__()
        self.norm_in, self.ff_in = LayerNorm(dim), FeedForward(dim)
        self.norm1, self.attn1 = LayerNorm(dim), Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = GroupedCrossAttention(dim, heads, dim_head, ctx_dim)
        self.norm3, self.ff = LayerNorm(dim), FeedForward(dim)

    def forward(self, x, frames, context):  # x [B*F, S, C] -> same
        bf, s, c = x.shape
        h = x.reshape(bf // frames, frames, s, c).transpose(1, 2).reshape(-1, frames, c)
        h = self.ff_in(h, self.norm_in) + h
        h = h + self.attn1(h, self.norm1)
        h = h + self.attn2(h, self.norm2, context)
        h = h + self.ff(h, self.norm3)
        return h.reshape(bf // frames, s, frames, c).transpose(1, 2).reshape(bf, s, c)


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, c, heads, ctx_dim):
        super().__init__()
        self.norm = GroupNorm(c, 1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, c // heads, ctx_dim)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(c, heads, c // heads, ctx_dim)])
        self.time_pos_embed = TimestepEmbedding(c, c * 4, c)
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(c, c)

    def forward(self, x, context):  # x [B, F, H, W, C], context [B*F, S, D]
        b, f, hh, ww, c = x.shape
        time_context = context.reshape(b, f, *context.shape[1:])[:, 0]
        residual = x.flatten(0, 1)
        h = self.proj_in(self.norm(residual).reshape(b * f, hh * ww, c))
        frame_ids = torch.arange(f, dtype=torch.float32, device=x.device).repeat(b)
        emb = self.time_pos_embed(sinusoid(frame_ids, c))[:, None]
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, context)
            h = self.time_mixer(h, tblk(h + emb, f, time_context))
        h = self.proj_out(h).reshape(b * f, hh, ww, c) + residual
        return h.reshape(b, f, hh, ww, c)


# --------------------------------------------------------------------- UNet

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """diffusers ``UNetSpatioTemporalConditionModel`` of SVD img2vid."""
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_attention_heads: Tuple[int, ...] = (5, 10, 10, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    remat: bool = False


def _down_blocks(cfg, temb):
    blocks, cin = [], cfg.block_out_channels[0]
    for i, c in enumerate(cfg.block_out_channels):
        blk = nn.Module()
        attn = i < len(cfg.block_out_channels) - 1  # the last block has no attention
        eps = 1e-6 if attn else 1e-5
        blk.resnets = nn.ModuleList([SpatioTemporalResBlock(cin if j == 0 else c, c, temb, eps)
                                     for j in range(cfg.layers_per_block)])
        if attn:
            blk.attentions = nn.ModuleList([
                TransformerSpatioTemporal(c, cfg.num_attention_heads[i], cfg.cross_attention_dim)
                for _ in range(cfg.layers_per_block)])
            blk.downsamplers = nn.ModuleList([Downsample(c)])
        blocks.append(blk)
        cin = c
    return nn.ModuleList(blocks)


def _mid_block(cfg, temb):
    c = cfg.block_out_channels[-1]
    blk = nn.Module()
    blk.resnets = nn.ModuleList([SpatioTemporalResBlock(c, c, temb, 1e-5) for _ in range(2)])
    blk.attentions = nn.ModuleList([
        TransformerSpatioTemporal(c, cfg.num_attention_heads[-1], cfg.cross_attention_dim)])
    return blk


def _call(remat, fn, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_down(blocks, x, temb, context):
    states = [x]
    for blk in blocks:
        for j, r in enumerate(blk.resnets):
            x = r(x, temb)
            if hasattr(blk, "attentions"):
                x = blk.attentions[j](x, context)
            states.append(x)
        if hasattr(blk, "downsamplers"):
            x = per_frame(blk.downsamplers[0], x)
            states.append(x)
    return x, states


def _run_mid(blk, x, temb, context):
    x = blk.resnets[0](x, temb)
    x = blk.attentions[0](x, context)
    return blk.resnets[1](x, temb)


def _embed(model, timestep, add_ids, b):
    ch0 = model.config.block_out_channels[0]
    t = timestep.float().reshape(-1).expand(b) if timestep.numel() == 1 else timestep.float()
    emb = model.time_embedding(sinusoid(t, ch0))
    ids = sinusoid(add_ids.reshape(-1), model.config.addition_time_embed_dim)
    return emb + model.add_embedding(ids.reshape(b, -1))


def _prologue(model, sample, timestep, states, add_ids):
    b, f = sample.shape[:2]
    emb = _embed(model, timestep, add_ids, b)
    temb = emb[:, None].expand(b, f, emb.shape[-1])
    return temb, states.float().repeat_interleave(f, dim=0)


class UNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        self.conv_in = Conv(cfg.in_channels, ch[0])
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = _down_blocks(cfg, temb)
        self.mid_block = _mid_block(cfg, temb)
        rev, heads = list(reversed(ch)), list(reversed(cfg.num_attention_heads))
        ups, prev = [], rev[0]
        for i, c in enumerate(rev):
            blk = nn.Module()
            cins = []
            for j in range(cfg.layers_per_block + 1):
                skip = rev[min(i + 1, len(rev) - 1)] if j == cfg.layers_per_block else c
                cins.append((prev if j == 0 else c) + skip)
            blk.resnets = nn.ModuleList([SpatioTemporalResBlock(ci, c, temb, 1e-6)
                                         for ci in cins])
            if i > 0:  # the first up block has no attention
                blk.attentions = nn.ModuleList([
                    TransformerSpatioTemporal(c, heads[i], cfg.cross_attention_dim)
                    for _ in cins])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(c)])
            ups.append(blk)
            prev = c
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(ch[0], 1e-5, True)
        self.conv_out = Conv(ch[0], cfg.out_channels)

    def forward(self, sample, timestep, states, add_ids, down_res=None, mid_res=None):
        """sample [B, F, h, w, 8], timestep scalar or [B], states [B, S, D],
        add_ids [B, 3], ControlNet residuals -> [B, F, h, w, 4]."""
        remat = self.config.remat
        temb, context = _prologue(self, sample, timestep, states, add_ids)
        x = per_frame(self.conv_in, sample.float())
        x, skips = _call(remat, _run_down, self.down_blocks, x, temb, context)
        if down_res is not None:
            skips = [s + r for s, r in zip(skips, down_res)]
        x = _call(remat, _run_mid, self.mid_block, x, temb, context)
        if mid_res is not None:
            x = x + mid_res
        n = self.config.layers_per_block + 1
        for blk in self.up_blocks:
            res, skips = skips[-n:], skips[:-n]
            x = _call(remat, self._up, blk, x, res, temb, context)
        return per_frame(lambda t: self.conv_out(self.conv_norm_out(t)), x)

    @staticmethod
    def _up(blk, x, res, temb, context):
        res = list(res)
        for j, r in enumerate(blk.resnets):
            x = r(torch.cat([x, res.pop()], dim=-1), temb)
            if hasattr(blk, "attentions"):
                x = blk.attentions[j](x, context)
        if hasattr(blk, "upsamplers"):
            x = per_frame(blk.upsamplers[0], x)
        return x


class ControlNet(nn.Module):
    """GestureNet: the UNet's down and mid path over ``cat(sample, VAE
    latents of the gesture raster)``, a 1x1 zero conv on every skip state and
    on the mid output, each scaled by ``conditioning_scale``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        self.conv_in_concat = Conv(cfg.in_channels + 4, ch[0])
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = _down_blocks(cfg, temb)
        self.mid_block = _mid_block(cfg, temb)
        widths = [ch[0]]
        for i, c in enumerate(ch):
            widths += [c] * (cfg.layers_per_block + (i < len(ch) - 1))
        self.controlnet_down_blocks = nn.ModuleList([Conv(c, c, 1) for c in widths])
        self.controlnet_mid_block = Conv(ch[-1], ch[-1], 1)

    def forward(self, sample, timestep, states, add_ids, cond, scale=1.0):
        temb, context = _prologue(self, sample, timestep, states, add_ids)
        x = per_frame(self.conv_in_concat, torch.cat([sample.float(), cond.float()], dim=-1))
        x, skips = _run_down(self.down_blocks, x, temb, context)
        x = _run_mid(self.mid_block, x, temb, context)
        res = [per_frame(conv, s) * scale for conv, s in zip(self.controlnet_down_blocks, skips)]
        return res, per_frame(self.controlnet_mid_block, x) * scale


# ---------------------------------------------------------------------- VAE

@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215


class VaeResnet(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin, 1e-6, True), Conv(cin, cout)
        self.norm2, self.conv2 = GroupNorm(cout, 1e-6, True), Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class VaeAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = GroupNorm(c, 1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, 1, c)
        o = ops.attention(self.to_q(t), self.to_k(t), self.to_v(t))
        return self.to_out[0](o.reshape(n, h * w, c)).reshape(n, h, w, c) + x


class EncoderDown(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv(3, ch[0])
        blocks, cin = [], ch[0]
        for i, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([VaeResnet(cin if j == 0 else c, c)
                                         for j in range(cfg.layers_per_block)])
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([EncoderDown(c)])
            blocks.append(blk)
            cin = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([VaeResnet(ch[-1], ch[-1]) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VaeAttention(ch[-1])])
        self.conv_norm_out = GroupNorm(ch[-1], 1e-6, True)
        self.conv_out = Conv(ch[-1], 2 * cfg.latent_channels)

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


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        top = ch[-1]

        def st(cin, cout):
            return SpatioTemporalResBlock(cin, cout, None, 1e-6, 1e-5, switch=True)

        self.conv_in = Conv(cfg.latent_channels, top)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([st(top, top) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([VaeAttention(top)])
        ups, prev = [], top
        for i, c in enumerate(reversed(ch)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList([st(prev if j == 0 else c, c)
                                         for j in range(cfg.layers_per_block + 1)])
            if i < len(ch) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(c)])
            ups.append(blk)
            prev = c
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(ch[0], 1e-6, True)
        self.conv_out = Conv(ch[0], 3)
        self.time_conv_out = TemporalConv(3, 3)

    def forward(self, z):  # [B, F, h, w, 4] -> [B, F, H, W, 3]
        h = per_frame(self.conv_in, z)
        mid = self.mid_block
        h = mid.resnets[1](per_frame(mid.attentions[0], mid.resnets[0](h)))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = per_frame(blk.upsamplers[0], h)
        h = per_frame(lambda t: self.conv_out(self.conv_norm_out(t)), h)
        return self.time_conv_out(h)


class VAE(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = TemporalDecoder(config)
        self.quant_conv = Conv(2 * config.latent_channels, 2 * config.latent_channels, 1)

    def encode_mode(self, x):
        """[N, H, W, 3] -> the posterior mean [N, H/8, W/8, 4]."""
        return self.quant_conv(self.encoder(x.float()))[..., :self.config.latent_channels]

    def decode(self, z):
        return self.decoder(z.float())


# --------------------------------------------------------------------- CLIP

@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """ViT-H/14 by default; the SD 2.1 text tower is hidden 1024, 23 layers,
    16 heads, intermediate 4096, 77 positions."""
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-5
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 1024
    vocab_size: int = 49408
    max_positions: int = 77


class ClipAttention(nn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj = Linear(c, c), Linear(c, c), Linear(c, c)
        self.out_proj = Linear(c, c)

    def forward(self, x, mask=None):
        b, s, c = x.shape
        q, k, v = (m(x).reshape(b, s, self.heads, -1)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(ops.attention(q, k, v, mask).reshape(b, s, c))


class ClipMLP(nn.Module):
    def __init__(self, c, inner):
        super().__init__()
        self.fc1, self.fc2 = Linear(c, inner), Linear(inner, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ClipLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = ClipAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = ClipMLP(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([ClipLayer(cfg) for _ in range(cfg.num_layers)])


class ClipText(nn.Module):
    """``input_ids`` [B, 77] -> the last hidden state [B, 77, 1024]."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        tm.encoder = _Encoder(cfg)
        tm.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        x = tm.embeddings.token_embedding(ids).float() \
            + tm.embeddings.position_embedding(pos)[None].float()
        mask = torch.ones((s, s), dtype=torch.bool, device=ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


class ClipVision(nn.Module):
    """CLIP-normalised ``[B, 224, 224, 3]`` -> the image embedding [B, 1024]."""

    def __init__(self, cfg: CLIPConfig = CLIPConfig()):
        super().__init__()
        patch, image = cfg.patch_size, cfg.image_size
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        vm.embeddings.patch_embedding = Conv(3, cfg.hidden_size, patch, stride=patch,
                                             padding=0, bias=False)
        vm.embeddings.position_embedding = nn.Embedding((image // patch) ** 2 + 1,
                                                        cfg.hidden_size)
        vm.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        vm.encoder = _Encoder(cfg)
        vm.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, px):
        vm, emb = self.vision_model, self.vision_model.embeddings
        b = px.shape[0]
        patches = emb.patch_embedding(px.float()).reshape(b, -1, emb.class_embedding.shape[0])
        x = torch.cat([emb.class_embedding.float().expand(b, 1, -1), patches], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        x = vm.pre_layrnorm(x + emb.position_embedding(pos)[None].float())
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


_BUILD = dict(unet=(UNet, UNetConfig), gesturenet=(ControlNet, UNetConfig),
              vae=(VAE, VAEConfig), image_encoder=(ClipVision, CLIPConfig),
              text_encoder=(ClipText, CLIPConfig))


def build(name: str, sizes: dict, remat: bool = False) -> nn.Module:
    """An uninitialised reference model by its weight-folder name, at the
    ``sizes`` of the configuration file (lists for tuples)."""
    cls, cfg = _BUILD[name]
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()
              if k in cfg.__dataclass_fields__}
    if "remat" in cfg.__dataclass_fields__:
        fields["remat"] = remat
    return cls(cfg(**fields))


def is_norm(module: nn.Module) -> bool:
    return isinstance(module, (GroupNorm, LayerNorm, AlphaBlender))
