"""Spatio-temporal transformer (counterpart of ``models/transformer.py``).

Per layer: a spatial block (self-attention over H*W tokens + cross-attention
on the encoder states) then a temporal block (attention over F frame tokens
with spatial positions folded into batch), merged by ONE AlphaBlender shared
by every layer.  The temporal cross-attention context is the first frame's
encoder states, broadcast hw-major as the reference does (row ``r`` of the
folded batch consumes context ``r % n``), computed per distinct context by
``GroupedCrossAttention``.  Every LayerNorm feeds its projection through
``ops.ln_matmul`` (K3).

``context_clips`` (the independent clips of a folded batch) may instead be
a :class:`CfgBranch`: the rows of one CFG branch run apart from the others
(the serving mesh's ``cfg`` axis), with the encoder states of every branch,
so that each row still meets the context the whole batch gives it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from .layers import (AlphaBlender, Attention, FeedForward, GroupNorm, LayerNorm,
                     TimestepEmbedding, sinusoidal_embedding)
from ..ops.ln_matmul import ln_matmul


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU-FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(x, ln=self.norm1)
        if hasattr(self, "attn2"):
            x = x + self.attn2(x, context, ln=self.norm2)
        return x + self.ff(x, ln=self.norm3)


@dataclasses.dataclass(frozen=True)
class CfgBranch:
    """The rows of CFG branch ``index`` of ``count`` of a folded batch of
    ``clips`` clips a branch, run as a batch of their own; ``states``: the
    encoder states of the whole folded batch, ``[count * clips, S, D]``."""

    clips: int
    index: int
    count: int
    states: torch.Tensor

    def contexts(self, rows: int) -> np.ndarray:
        """The context of each of the branch's ``rows`` (clip-major, ``s``
        spatial rows a clip) in the whole batch: the map of
        ``_clip_exact_order``, ``((j * s + p) % count) * clips + i``."""
        s = rows // self.clips
        r = np.arange(rows)
        return ((self.index * s + r % s) % self.count) * self.clips + r // s


@functools.lru_cache(maxsize=256)
def _clip_exact_order(r: int, n: int, clips: int, device: torch.device):
    """Row permutation for the per-clip exact context mapping (see the JAX
    ``_clip_exact_order``): rows grouped context-major, and its inverse, as
    index tensors on ``device``, made once a layout: a copy to the card on
    every forward would be a host-to-device copy inside a captured step."""
    if r % n or n % clips:
        raise ValueError(
            f"context_clips={clips} must divide the {n} contexts and rows "
            f"({r}) must fold evenly — got a non-divisible batch layout")
    s = r // n
    mult = n // clips
    rows = np.arange(r)
    b, p = rows // s, rows % s
    i, j = b % clips, b // clips
    ctx = ((j * s + p) % mult) * clips + i
    order = np.argsort(ctx, kind="stable")
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(np.argsort(order)).to(device))


class GroupedCrossAttention(nn.Module):
    """Cross-attention where rows share only ``n`` distinct contexts; K/V
    are projected once per context.  Param layout of diffusers ``Attention``."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(cross_attention_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_attention_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x_rows, ctx, ln: LayerNorm, clips=1):
        if isinstance(clips, CfgBranch):
            return self._branch_forward(x_rows, ctx, ln, clips)
        r, f, c = x_rows.shape
        n = ctx.shape[0]
        hd, dh = self.heads, self.dim_head
        q = ln_matmul(x_rows, ln.weight, ln.bias, self.to_q.weight, eps=ln.eps)
        k = self.to_k(ctx).reshape(n, -1, hd, dh)
        v = self.to_v(ctx).reshape(n, -1, hd, dh)
        m = r // n
        inv = None
        if clips == 1:
            q = q.reshape(m, n, f, hd, dh).transpose(0, 1)
        else:
            order, inv = _clip_exact_order(r, n, clips, q.device)
            q = q[order].reshape(n, m, f, hd, dh)
        logits = torch.einsum("cmfhd,ckhd->cmhfk", q.float(), k.float()) * dh ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("cmhfk,ckhd->cmfhd", probs, v)
        if inv is None:
            out = out.transpose(0, 1).reshape(r, f, hd * dh)
        else:
            out = out.reshape(r, f, hd * dh)[inv]
        return self.to_out[0](out)

    def _branch_forward(self, x_rows, ctx, ln: LayerNorm, br: CfgBranch):
        """The rows of one CFG branch against the whole batch's contexts
        (``br.states``): each context's rows attend to it in turn."""
        r, f, c = x_rows.shape
        hd, dh = self.heads, self.dim_head
        q = ln_matmul(x_rows, ln.weight, ln.bias, self.to_q.weight, eps=ln.eps)
        q = q.reshape(r, f, hd, dh)
        states = br.states.to(ctx.dtype)
        n = states.shape[0]
        k = self.to_k(states).reshape(n, -1, hd, dh)
        v = self.to_v(states).reshape(n, -1, hd, dh)
        which = br.contexts(r)
        out = torch.empty((r, f, hd, dh), dtype=v.dtype, device=q.device)
        for cidx in np.unique(which):
            sel = torch.from_numpy(np.flatnonzero(which == cidx)).to(q.device)
            logits = torch.einsum("mfhd,khd->mhfk", q[sel].float(), k[cidx].float()) * dh ** -0.5
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out[sel] = torch.einsum("mhfk,khd->mfhd", probs, v[cidx])
        return self.to_out[0](out.reshape(r, f, hd * dh))


class TemporalBasicTransformerBlock(nn.Module):
    """Attention over the frame axis with spatial tokens folded into batch:
    input ``[B*F, S, C]``, internally ``[B*S, F, C]``."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        if cross_attention_dim is not None:
            self.norm2 = LayerNorm(dim)
            self.attn2 = GroupedCrossAttention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, num_frames: int, context=None, clips: int = 1):
        bf, s, c = x.shape
        b = bf // num_frames
        # contiguous: at b == 1 the fold is a strided view, which K3 does not take
        h = x.reshape(b, num_frames, s, c).transpose(1, 2).reshape(b * s, num_frames, c)
        h = h.contiguous()
        h = self.ff_in(h, ln=self.norm_in) + h  # is_res: dim == time_mix_inner_dim
        h = h + self.attn1(h, ln=self.norm1)
        if hasattr(self, "attn2"):
            h = h + self.attn2(h, context, ln=self.norm2, clips=clips)
        h = h + self.ff(h, ln=self.norm3)
        return h.reshape(b, s, num_frames, c).transpose(1, 2).reshape(bf, s, c)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, in_channels: int, heads: int, dim_head: int, num_layers: int = 1,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, in_channels, 1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim)
            for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, heads, dim_head, cross_attention_dim)
            for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(in_channels, in_channels * 4,
                                                out_dim=in_channels)
        # ONE AlphaBlender shared across layers, as diffusers builds it
        self.time_mixer = AlphaBlender("learned_with_images")
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context, image_only_indicator=None, context_clips: int = 1):
        # x [B, F, H, W, C]; context [B*F, S, D] (frame-repeated); context_clips:
        # independent clips in the batch (1 = the reference CFG-pair quirk)
        b, f, hh, ww, c = x.shape
        time_context = context.reshape(b, f, *context.shape[1:])[:, 0]
        residual = x.reshape(b * f, hh, ww, c)
        h = self.norm(residual).reshape(b * f, hh * ww, c)
        h = self.proj_in(h)

        frame_ids = torch.arange(f, dtype=torch.float32, device=x.device).repeat(b)
        t_emb = sinusoidal_embedding(frame_ids, c).to(h.dtype)
        emb = self.time_pos_embed(t_emb)[:, None, :]

        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, context)
            h_mix = tblk(h + emb, f, time_context, clips=context_clips)
            h = self.time_mixer(h, h_mix, image_only_indicator)

        h = self.proj_out(h).reshape(b * f, hh, ww, c) + residual
        return h.reshape(b, f, hh, ww, c)
