"""FlowFormer optical flow (counterpart of ``models/flowformer.py``), fp32.

The trajectory stage's second flow network (Huang et al., ECCV 2022, as
config/flowformer_config.py describes it), the same architecture as the
JAX module:

  * feature and context encoders: the first two Twins-SVT stages (4x4 and
    2x2 patch embeds; locally grouped attention in windows, global
    sub-sampled attention; a PEG depthwise conv after each stage's first
    block), 1/8 resolution;
  * the all-pairs cost volume (RAFT's ``build_corr_pyramid``, one level);
  * the cost memory encoder: each source pixel's cost map patchified into
    tokens with a linear positional encoding, summarised into K latent
    tokens by cross-attention, then alternate-group transformer layers
    (self-attention over a pixel's K latents, then windowed attention over
    the source grid, one group per latent index);
  * the recurrent decoder: a 9x9 local cost lookup around the current flow,
    a query cross-attending to the pixel's cost memory, a motion encoder,
    GMA over the context, RAFT's separable ConvGRU and convex upsampling,
    iterated ``decoder_depth`` times in a plain loop.

Module names are the flax ones, so a ``flowformer_params_save`` archive maps
onto the state dict by joining its path (``weights/convert.
flax_flowformer_params_to_torch``); ``save_flowformer`` / ``load_flowformer``
write and read that ``.npz`` format (the JAX loader reads what the port
writes).  Flax's defaults are kept: LayerNorm eps 1e-6, tanh-approximate
GELU, SAME padding.  Tokens run channels-last ``[B, H, W, C]``; the
decoder's convolutions NCHW.  Images go in as ``[B, H, W, 3]`` in [0, 255]
(H, W multiples of 8).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .raft import (SepConvGRU, bilinear_sample, build_corr_pyramid, coords_grid,
                   pad_to_multiple, upsample_flow_convex)
from .resnet import Conv2d  # channels-last; SAME padding for the odd kernels here

__all__ = ["FlowFormerConfig", "FlowFormer", "flowformer_forward", "save_flowformer",
           "load_flowformer", "pad_to_multiple"]


@dataclass(frozen=True)
class FlowFormerConfig:
    embed_dims: Tuple[int, int] = (128, 256)
    depths: Tuple[int, int] = (2, 2)
    num_heads: Tuple[int, int] = (4, 8)
    window_size: int = 7
    sr_ratios: Tuple[int, int] = (8, 4)
    mlp_ratio: int = 4
    patch_size: int = 8
    cost_latent_input_dim: int = 64
    cost_latent_token_num: int = 8
    cost_latent_dim: int = 128
    cost_heads_num: int = 1
    encoder_depth: int = 3
    query_latent_dim: int = 64
    decoder_depth: int = 12
    hdim: int = 128
    cdim: int = 128
    use_gma: bool = True

    @property
    def encoder_latent_dim(self) -> int:
        return self.embed_dims[-1]

    @classmethod
    def sintel(cls) -> "FlowFormerConfig":
        """The reference config/flowformer_config.py values."""
        return cls()

    @classmethod
    def tiny(cls) -> "FlowFormerConfig":
        """Test size: the same topology."""
        return cls(embed_dims=(16, 32), depths=(2, 2), num_heads=(2, 2), window_size=4,
                   sr_ratios=(4, 2), mlp_ratio=2, patch_size=4, cost_latent_input_dim=16,
                   cost_latent_token_num=4, cost_latent_dim=32, cost_heads_num=1,
                   encoder_depth=1, query_latent_dim=16, decoder_depth=3, hdim=16, cdim=16)

    @classmethod
    def from_dict(cls, d) -> "FlowFormerConfig":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)  # flax's default eps


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(_gelu(self.fc1(x)))


def _window_fold(x: torch.Tensor, ws: int):
    """``[B, H, W, C]`` -> (``[B*nh*nw, ws*ws, C]``, pad_h, pad_w): the grid
    zero-padded at the bottom and right to a window multiple, the windows
    folded into the batch; padded tokens take part in attention, as in JAX."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    nh, nw = (h + ph) // ws, (w + pw) // ws
    x = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, ws * ws, c), ph, pw


def _window_unfold(x: torch.Tensor, b: int, h: int, w: int, ws: int, ph: int, pw: int):
    nh, nw = (h + ph) // ws, (w + pw) // ws
    x = x.reshape(b, nh, nw, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h + ph, w + pw, -1)[:, :h, :w]


def _mhsa(q, k, v, heads: int):
    """Batched multi-head attention: ``[B, Nq, C] x [B, Nk, C]``."""
    b, nq, c = q.shape
    nk, d = k.shape[1], c // heads
    q = q.reshape(b, nq, heads, d).transpose(1, 2)
    k = k.reshape(b, nk, heads, d).transpose(1, 2)
    v = v.reshape(b, nk, heads, d).transpose(1, 2)
    a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(np.float32(d))), -1)
    return torch.matmul(a, v).transpose(1, 2).reshape(b, nq, c)


class LocallyGroupedAttn(nn.Module):
    """Twins LSA: self-attention inside ws x ws windows of the grid."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, _ = x.shape
        t, ph, pw = _window_fold(x, self.ws)
        q, k, v = self.qkv(t).chunk(3, -1)
        o = self.proj(_mhsa(q, k, v, self.heads))
        return _window_unfold(o, b, h, w, self.ws, ph, pw)


class GlobalSubsampledAttn(nn.Module):
    """Twins GSA: every token attends to a stride-sr pooled key/value set."""

    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads, self.ratio = heads, sr
        self.q = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = Conv2d(dim, dim, sr, stride=sr, padding=0)
            self.sr_norm = _layer_norm(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        q = self.q(x.reshape(b, h * w, c))
        kv_in = x
        if self.ratio > 1:
            kv_in = F.pad(x, (0, 0, 0, (-w) % self.ratio, 0, (-h) % self.ratio))
            kv_in = self.sr_norm(self.sr(kv_in))
        k, v = self.kv(kv_in.reshape(b, -1, c)).chunk(2, -1)
        return self.proj(_mhsa(q, k, v, self.heads)).reshape(b, h, w, c)


class TwinsBlock(nn.Module):
    """Pre-norm transformer block on the ``[B, H, W, C]`` grid: LSA when
    ``ws > 0``, else GSA."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, ws: int = 0, sr: int = 1):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = (LocallyGroupedAttn(dim, heads, ws) if ws > 0
                     else GlobalSubsampledAttn(dim, heads, sr))
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PEG(nn.Module):
    """Twins positional-encoding generator: residual depthwise 3x3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv2d(dim, dim, 3, groups=dim)

    def forward(self, x):
        return x + self.proj(x)


class TwinsEncoder(nn.Module):
    """Twins-SVT's first two stages: 1/8 resolution, embed_dims[-1] wide."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        cin = 3
        self.stages = []
        for si, (dim, depth, heads, sr) in enumerate(zip(cfg.embed_dims, cfg.depths,
                                                         cfg.num_heads, cfg.sr_ratios)):
            patch = 4 if si == 0 else 2
            setattr(self, f"patch_embed{si}", Conv2d(cin, dim, patch, stride=patch, padding=0))
            setattr(self, f"patch_norm{si}", _layer_norm(dim))
            for bi in range(depth):
                ws = cfg.window_size if bi % 2 == 0 else 0
                setattr(self, f"stage{si}_block{bi}",
                        TwinsBlock(dim, heads, cfg.mlp_ratio, ws=ws, sr=sr))
            setattr(self, f"stage{si}_peg", PEG(dim))
            self.stages.append(depth)
            cin = dim

    def forward(self, x):  # [B, H, W, 3]
        for si, depth in enumerate(self.stages):
            x = getattr(self, f"patch_norm{si}")(getattr(self, f"patch_embed{si}")(x))
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x)
                if bi == 0:
                    x = getattr(self, f"stage{si}_peg")(x)
        return x


def _linear_pe(pe: nn.Linear, h: int, w: int, device) -> torch.Tensor:
    """The linear positional encoding of the normalised (x, y, 1) grid."""
    ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=device),
                            torch.linspace(-1.0, 1.0, w, device=device), indexing="ij")
    return pe(torch.stack([xs, ys, torch.ones_like(xs)], -1))


class CostMemoryEncoder(nn.Module):
    """Cost maps ``[B*h*w, h2, w2, 1]`` -> cost memory ``[B*h*w, K, D]``."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        p, d, din = cfg.patch_size, cfg.cost_latent_dim, cfg.cost_latent_input_dim
        self.patch_embed = Conv2d(1, din, p, stride=p, padding=0)
        self.token_pe = nn.Linear(3, din, bias=False)
        self.token_proj = nn.Linear(din, d)
        self.latents = nn.Parameter(torch.randn(cfg.cost_latent_token_num, d) * 0.02)
        self.xattn_norm = _layer_norm(d)
        self.xattn_q, self.xattn_k, self.xattn_v = (nn.Linear(d, d) for _ in range(3))
        self.xattn_proj = nn.Linear(d, d)
        self.xattn_mlp_norm = _layer_norm(d)
        self.xattn_mlp = Mlp(d, d * cfg.mlp_ratio)
        for li in range(cfg.encoder_depth):
            setattr(self, f"agt{li}_intra_norm", _layer_norm(d))
            setattr(self, f"agt{li}_intra_qkv", nn.Linear(d, 3 * d))
            setattr(self, f"agt{li}_intra_proj", nn.Linear(d, d))
            setattr(self, f"agt{li}_intra_mlp_norm", _layer_norm(d))
            setattr(self, f"agt{li}_intra_mlp", Mlp(d, d * cfg.mlp_ratio))
            setattr(self, f"agt{li}_inter",
                    TwinsBlock(d, cfg.cost_heads_num, cfg.mlp_ratio, ws=cfg.window_size))

    def forward(self, cost_maps, h1: int, w1: int):
        cfg = self.cfg
        p, k_num, d, heads = (cfg.patch_size, cfg.cost_latent_token_num, cfg.cost_latent_dim,
                              cfg.cost_heads_num)
        n, h2, w2, _ = cost_maps.shape
        b = n // (h1 * w1)
        x = self.patch_embed(F.pad(cost_maps, (0, 0, 0, (-w2) % p, 0, (-h2) % p)))
        th, tw = x.shape[1], x.shape[2]
        x = x + _linear_pe(self.token_pe, th, tw, x.device)
        tokens = self.token_proj(x.reshape(n, th * tw, -1))

        q = self.latents[None].expand(n, -1, -1)
        y = self.xattn_norm(tokens)
        mem = q + self.xattn_proj(_mhsa(self.xattn_q(q), self.xattn_k(y), self.xattn_v(y),
                                        heads))
        mem = mem + self.xattn_mlp(self.xattn_mlp_norm(mem))
        for li in range(cfg.encoder_depth):
            layer = lambda name: getattr(self, f"agt{li}_{name}")  # noqa: E731
            q3, k3, v3 = layer("intra_qkv")(layer("intra_norm")(mem)).chunk(3, -1)
            mem = mem + layer("intra_proj")(_mhsa(q3, k3, v3, heads))
            mem = mem + layer("intra_mlp")(layer("intra_mlp_norm")(mem))
            grid = mem.reshape(b, h1, w1, k_num, d).permute(0, 3, 1, 2, 4)
            grid = layer("inter")(grid.reshape(b * k_num, h1, w1, d))
            mem = grid.reshape(b, k_num, h1, w1, d).permute(0, 2, 3, 1, 4).reshape(n, k_num, d)
        return mem


class CostQueryDecoder(nn.Module):
    """Local 9x9 cost + flow-position PE -> a query cross-attending to the
    pixel's cost memory -> decoded cost feature ``[B, h, w, D]``."""

    def __init__(self, cfg: FlowFormerConfig, local_dim: int):
        super().__init__()
        self.heads = cfg.cost_heads_num
        d, dq = cfg.cost_latent_dim, cfg.query_latent_dim
        self.query_embed = nn.Linear(local_dim, dq)
        self.query_pe = nn.Linear(2, dq, bias=False)
        self.q = nn.Linear(dq, d)
        self.mem_norm = _layer_norm(d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)

    def memory_kv(self, memory):
        """The keys and values of the cost memory (the same every iteration)."""
        y = self.mem_norm(memory)
        return self.k(y), self.v(y)

    def forward(self, local_cost, coords_norm, kv):
        b, h1, w1, _ = local_cost.shape
        q = self.q(_gelu(self.query_embed(local_cost) + self.query_pe(coords_norm)))
        o = self.proj(_mhsa(q.reshape(b * h1 * w1, 1, -1), *kv, self.heads))
        return o.reshape(b, h1, w1, -1)


class FFMotionEncoder(nn.Module):
    """[local cost, decoded cost] + flow -> motion features (hdim wide, the
    flow appended), NCHW."""

    def __init__(self, cfg: FlowFormerConfig, corr_dim: int):
        super().__init__()
        h = cfg.hdim
        self.convc1 = nn.Conv2d(corr_dim, 2 * h, 1)
        self.convc2 = nn.Conv2d(2 * h, 3 * h // 2, 3, padding=1)
        self.convf1 = nn.Conv2d(2, h, 7, padding=3)
        self.convf2 = nn.Conv2d(h, h // 2, 3, padding=1)
        self.conv = nn.Conv2d(3 * h // 2 + h // 2, h - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], 1))), flow], 1)


class GMA(nn.Module):
    """Global motion aggregation: attention from the context, values from the
    motion features, a learned-gamma residual."""

    def __init__(self, ctx_dim: int, dim: int):
        super().__init__()
        self.dim = dim
        self.to_q = nn.Linear(ctx_dim, dim)
        self.to_k = nn.Linear(ctx_dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.gamma = nn.Parameter(torch.zeros(()))

    def attention(self, context):
        """``[B, h*w, h*w]`` softmax of the context's queries and keys (the
        same every iteration)."""
        b, h, w, _ = context.shape
        q = self.to_q(context).reshape(b, h * w, -1)
        k = self.to_k(context).reshape(b, h * w, -1)
        return torch.softmax(torch.bmm(q, k.transpose(1, 2))
                             / float(np.sqrt(np.float32(self.dim))), -1)

    def forward(self, attn, motion):  # motion NCHW
        b, c, h, w = motion.shape
        v = self.to_v(motion.flatten(2).transpose(1, 2))
        o = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return motion + self.gamma * o


class FFUpdateBlock(nn.Module):
    """One decoder iteration: motion encoding (+GMA) -> SepConvGRU ->
    (delta flow, convex-upsampling mask), NCHW."""

    def __init__(self, cfg: FlowFormerConfig, corr_dim: int):
        super().__init__()
        h = cfg.hdim
        self.use_gma = cfg.use_gma
        self.encoder = FFMotionEncoder(cfg, corr_dim)
        if cfg.use_gma:
            self.gma = GMA(cfg.encoder_latent_dim, h)
        self.gru = SepConvGRU(h, cfg.cdim + h * (2 if cfg.use_gma else 1))
        self.flow_head_conv1 = nn.Conv2d(h, 2 * h, 3, padding=1)
        self.flow_head_conv2 = nn.Conv2d(2 * h, 2, 3, padding=1)
        self.mask_0 = nn.Conv2d(h, 2 * h, 3, padding=1)
        self.mask_2 = nn.Conv2d(2 * h, 64 * 9, 1)

    def forward(self, net, inp, corr, flow, attn):
        motion = self.encoder(flow, corr)
        feats = [inp, motion]
        if self.use_gma:
            feats.append(self.gma(attn, motion))
        net = self.gru(net, torch.cat(feats, 1))
        delta = self.flow_head_conv2(F.relu(self.flow_head_conv1(net)))
        mask = 0.25 * self.mask_2(F.relu(self.mask_0(net)))
        return net, mask, delta


class FlowFormer(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        local_dim = 81  # the 9x9 window of the cost lookup
        self.fnet = TwinsEncoder(cfg)
        self.cnet = TwinsEncoder(cfg)
        self.memory_encoder = CostMemoryEncoder(cfg)
        self.query_decoder = CostQueryDecoder(cfg, local_dim)
        self.update_block = FFUpdateBlock(cfg, local_dim + cfg.cost_latent_dim)
        self.context_proj = nn.Linear(cfg.encoder_latent_dim, cfg.hdim + cfg.cdim)

    def encode(self, image1, image2):
        """images ``[B, H, W, 3]`` in [0, 255] -> (cost maps ``[B*h*w, h, w]``,
        cost memory, net, inp (NCHW), context ``[B, h, w, C]``)."""
        x = 2.0 * (torch.cat([image1, image2], 0) / 255.0) - 1.0
        f1, f2 = self.fnet(x).chunk(2)
        h1, w1 = f1.shape[1:3]
        cost_maps = build_corr_pyramid(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2), 1)[0]
        memory = self.memory_encoder(cost_maps[..., None], h1, w1)
        c = self.cnet(2.0 * (image1 / 255.0) - 1.0)
        ctx = self.context_proj(c).permute(0, 3, 1, 2)
        net = torch.tanh(ctx[:, :self.cfg.hdim])
        inp = F.relu(ctx[:, self.cfg.hdim:])
        return cost_maps, memory, net, inp, c

    def update(self, net, inp, attn, kv, cost_maps, coords0, coords1):
        """One iteration; coords ``[B, h, w, 2]`` (x, y)."""
        b, h1, w1, _ = coords1.shape
        d = torch.linspace(-4.0, 4.0, 9, device=coords1.device)
        oy, ox = torch.meshgrid(d, d, indexing="ij")
        off = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)
        local = bilinear_sample(cost_maps, coords1.reshape(b * h1 * w1, 1, 2) + off[None])
        local = local.reshape(b, h1, w1, -1)
        norm = coords1.new_tensor([max(w1 - 1, 1), max(h1 - 1, 1)])
        decoded = self.query_decoder(local, 2.0 * coords1 / norm - 1.0, kv)
        corr = torch.cat([local, decoded], -1).permute(0, 3, 1, 2)
        flow = (coords1 - coords0).permute(0, 3, 1, 2)
        return self.update_block(net, inp, corr, flow, attn)


def flowformer_forward(model: FlowFormer, image1, image2, iters: int = 0,
                       return_all: bool = False):
    """Encode once, iterate the decoder, upsample convexly.  Returns
    (flow_low ``[B, H/8, W/8, 2]``, flow_up ``[B, H, W, 2]``), with
    ``return_all`` also every iteration's low-resolution flow
    ``[iters, B, H/8, W/8, 2]``."""
    iters = iters or model.cfg.decoder_depth
    cost_maps, memory, net, inp, context = model.encode(image1, image2)
    b, h1, w1 = context.shape[:3]
    coords0 = coords_grid(b, h1, w1, context.device).permute(0, 2, 3, 1)
    coords1 = coords0
    kv = model.query_decoder.memory_kv(memory)
    attn = model.update_block.gma.attention(context) if model.cfg.use_gma else None
    every, mask = [], None
    for _ in range(iters):
        net, mask, delta = model.update(net, inp, attn, kv, cost_maps, coords0, coords1)
        coords1 = coords1 + delta.permute(0, 2, 3, 1)
        every.append(coords1 - coords0)
    flow_low = coords1 - coords0
    flow_up = upsample_flow_convex(flow_low.permute(0, 3, 1, 2), mask).permute(0, 2, 3, 1)
    if return_all:
        return flow_low, flow_up, torch.stack(every)
    return flow_low, flow_up


# ----------------------------------------------------------------- .npz files


def save_flowformer(path: str, model: FlowFormer) -> None:
    """The model's parameters and config in ``flowformer_params_save``'s
    ``.npz`` format (self-describing: the config rides along)."""
    from ..weights.convert import torch_flowformer_state_dict_to_flax, write_flowformer_npz

    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    write_flowformer_npz(path, torch_flowformer_state_dict_to_flax(sd),
                         dataclasses.asdict(model.cfg))


def load_flowformer(path: str, cfg: Optional[FlowFormerConfig] = None) -> FlowFormer:
    """A FlowFormer built from an archive's config (or ``cfg``) and loaded
    strictly from its parameters, on the CPU."""
    from ..weights.convert import flax_flowformer_params_to_torch, read_flowformer_npz

    params, stored = read_flowformer_npz(path)
    if cfg is None:
        if stored is None:
            raise ValueError(f"{path!r} has no embedded __config__ and no cfg was given")
        cfg = FlowFormerConfig.from_dict(stored)
    with torch.device("meta"):
        model = FlowFormer(cfg)
    sd = {k: torch.from_numpy(v) for k, v in flax_flowformer_params_to_torch(params).items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()
