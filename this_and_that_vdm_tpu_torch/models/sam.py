"""Segment Anything (counterpart of ``models/sam.py``), fp32, eval only.

The curation stages prompt SAM with a point and a box (the This/That
labeler) or with labelled points (the trajectory stage).  The modules carry
the state-dict names of the published ``sam_vit_{b,l,h}`` checkpoints
(facebookresearch/segment-anything), so a file loads with
``load_state_dict(strict=True)``.  ``encode_image`` takes ``[B, S, S, 3]``
SAM-normalised pixels and returns the ``[B, g, g, C]`` embedding;
``predict`` returns low-resolution mask logits ``[P, T, 4g, 4g]`` and IoU
predictions ``[P, T]``.  Prompts are padded to a fixed count of slots with
"not a point" labels by the caller (``curation/detectors``), as in the JAX
package: each slot is an attention token, so the padding is part of the
result.

Host-side pre- and postprocessing needs neither PIL nor JAX: the
longest-side resize is PIL's fixed-point bilinear (``data/image``), the
mask upscale is ``F.interpolate`` with ``antialias=True`` (the JAX
``jax.image.resize`` bilinear antialiases a downsample).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# SAM input normalisation (official sam.py pixel_mean/pixel_std buffers).
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0


@dataclass(frozen=True)
class SamConfig:
    """Architecture hyperparameters (official ``build_sam.py`` registry)."""

    img_size: int = 1024
    patch_size: int = 16
    # image encoder (ViT-H defaults)
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    mlp_ratio: float = 4.0
    # prompt encoder / decoder
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @classmethod
    def vit_h(cls) -> "SamConfig":
        return cls()

    @classmethod
    def vit_l(cls) -> "SamConfig":
        return cls(encoder_embed_dim=1024, encoder_depth=24, encoder_num_heads=16,
                   encoder_global_attn_indexes=(5, 11, 17, 23))

    @classmethod
    def vit_b(cls) -> "SamConfig":
        return cls(encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
                   encoder_global_attn_indexes=(2, 5, 8, 11))

    @classmethod
    def tiny(cls) -> "SamConfig":
        """Test-size config: 64px image, 4x4 token grid, 2 blocks."""
        return cls(img_size=64, patch_size=16, encoder_embed_dim=32, encoder_depth=2,
                   encoder_num_heads=2, encoder_global_attn_indexes=(1,), window_size=2,
                   prompt_embed_dim=16, mask_in_chans=4, decoder_mlp_dim=32,
                   decoder_num_heads=2, iou_head_hidden_dim=16)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (official common.py)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    """Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


# --------------------------------------------------------------------------
# Image encoder
# --------------------------------------------------------------------------


def _rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """[2*S-1, Dh] table -> [S, S, Dh] relative embeddings (official
    ``get_rel_pos``; the table is sized for the block, no interpolation)."""
    coords = torch.arange(size, device=table.device)
    return table[coords[:, None] - coords[None, :] + (size - 1)]


class ViTAttention(nn.Module):
    """Windowed or global attention with the decomposed relative-position
    bias, built from the unscaled queries (official ``add_decomposed_rel_pos``)."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x):  # [B, H, W, C]
        b, h, w, c = x.shape
        nh, dh = self.num_heads, c // self.num_heads
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, nh, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, nH, S, Dh]
        rq = q.reshape(b, nh, h, w, dh)
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", rq, _rel_pos(self.rel_pos_h, h))
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", rq, _rel_pos(self.rel_pos_w, w))
        attn = (q * dh ** -0.5) @ k.transpose(-2, -1)
        attn = (attn.view(b, nh, h, w, h, w) + bias_h[..., :, None] + bias_w[..., None, :])
        attn = attn.view(b, nh, h * w, h * w).softmax(-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b, h, w, c)
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> [B*nW, ws, ws, C] with bottom/right zero padding."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, padded_hw, out_hw):
    hp, wp = padded_hw
    h, w = out_hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class Block(nn.Module):
    def __init__(self, cfg: SamConfig, window_size: int):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = ViTAttention(d, cfg.encoder_num_heads,
                                 window_size if window_size > 0 else cfg.grid_size)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = MLPBlock(d, int(d * cfg.mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            hw = x.shape[1:3]
            x, padded = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(x), self.window_size, padded, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.encoder_embed_dim, cfg.patch_size, cfg.patch_size)

    def forward(self, x):  # [B, 3, S, S] -> [B, g, g, C]
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        g, d, c = cfg.grid_size, cfg.encoder_embed_dim, cfg.prompt_embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, d))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.encoder_global_attn_indexes else cfg.window_size)
            for i in range(cfg.encoder_depth))
        self.neck = nn.Sequential(nn.Conv2d(d, c, 1, bias=False), LayerNorm2d(c),
                                  nn.Conv2d(c, c, 3, padding=1, bias=False), LayerNorm2d(c))

    def forward(self, x):  # [B, S, S, 3] -> [B, g, g, C]
        x = self.patch_embed(x.permute(0, 3, 1, 2)) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Prompt encoder
# --------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    """Random-fourier positional encoding over a fixed gaussian matrix."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward(self, coords01):  # [..., 2] in [0, 1]
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, size: int) -> torch.Tensor:
        """[size, size, 2*num_pos_feats] dense PE over pixel centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        c = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
        yy, xx = torch.meshgrid(c, c, indexing="ij")
        return self(torch.stack([xx, yy], dim=-1))


class PromptEncoder(nn.Module):
    """Points, boxes (as two corner points, labels 2 and 3) and an optional
    mask -> sparse ``[P, N, C]`` and dense ``[P, g, g, C]`` embeddings.
    Labels: 1 positive, 0 negative, -1 "not a point"."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        c, m = cfg.prompt_embed_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(c // 2)
        # official order: [neg point, pos point, box corner 1, box corner 2]
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, c) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, c)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, m // 4, 2, 2), LayerNorm2d(m // 4), nn.GELU(),
            nn.Conv2d(m // 4, m, 2, 2), LayerNorm2d(m), nn.GELU(), nn.Conv2d(m, c, 1))
        self.no_mask_embed = nn.Embedding(1, c)

    def forward(self, points_xy, labels, mask_input=None):
        """points_xy [P, N, 2] in input-image pixels, already +0.5-centred
        (``transform_coords_np``); labels [P, N]; mask_input optional
        [P, 4g, 4g, 1] low-res mask logits."""
        cfg = self.cfg
        pe = self.pe_layer(points_xy / cfg.img_size)
        lbl = labels[..., None]
        table = torch.stack([self.not_a_point_embed.weight[0]]
                            + [e.weight[0] for e in self.point_embeddings])  # labels -1..3
        sparse = torch.where(lbl == -1, torch.zeros_like(pe), pe) + table[labels.long() + 1]
        g = cfg.grid_size
        if mask_input is None:
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                points_xy.shape[0], g, g, cfg.prompt_embed_dim)
        else:
            dense = self.mask_downscaling(mask_input.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return sparse, dense

    def dense_pe(self):
        return self.pe_layer.grid(self.cfg.grid_size)


# --------------------------------------------------------------------------
# Mask decoder
# --------------------------------------------------------------------------


class DecoderAttention(nn.Module):
    """Decoder attention with optional internal downsampling."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        q, k, v = (self._heads(self.q_proj(q)), self._heads(self.k_proj(k)),
                   self._heads(self.v_proj(v)))
        attn = ((q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])).softmax(-1)
        out = (attn @ v).transpose(1, 2)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_layer_pe: bool):
        super().__init__()
        c, nh = cfg.prompt_embed_dim, cfg.decoder_num_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(c, nh)
        self.norm1 = nn.LayerNorm(c)
        self.cross_attn_token_to_image = DecoderAttention(c, nh, 2)
        self.norm2 = nn.LayerNorm(c)
        self.mlp = MLPBlock(c, cfg.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(c)
        self.norm4 = nn.LayerNorm(c)
        self.cross_attn_image_to_token = DecoderAttention(c, nh, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c = cfg.prompt_embed_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(cfg, i == 0)
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(c, cfg.decoder_num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(c)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """ReLU MLP (official mask_decoder.py MLP, no sigmoid)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k)
                                    for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        c, t = cfg.prompt_embed_dim, cfg.num_mask_tokens
        self.cfg = cfg
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(t, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2), LayerNorm2d(c // 4), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(c, c, c // 8, 3) for _ in range(t))
        self.iou_prediction_head = MLP(c, cfg.iou_head_hidden_dim, t, cfg.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt):
        """image_embeddings [1, g, g, C] (broadcast over the prompt sets),
        image_pe [g, g, C], sparse [P, N, C], dense [P, g, g, C]."""
        cfg = self.cfg
        p, t = sparse_prompt.shape[0], cfg.num_mask_tokens
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([tokens[None].expand(p, -1, -1), sparse_prompt], 1)
        src = image_embeddings.expand(p, -1, -1, -1) + dense_prompt
        pos = image_pe[None].expand_as(src)
        hs, src = self.transformer(src, pos, tokens)
        g, c = cfg.grid_size, cfg.prompt_embed_dim
        up = self.output_upscaling(src.reshape(p, g, g, c).permute(0, 3, 1, 2))  # [P, C/8, 4g, 4g]
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)  # [P, T, C/8]
        masks = (hyper @ up.flatten(2)).view(p, t, up.shape[2], up.shape[3])
        return masks, self.iou_prediction_head(hs[:, 0])


class Sam(nn.Module):
    """Full SAM: ``encode_image`` once per frame, then ``predict`` per
    prompt set (the official SamPredictor split)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, pixels):
        """[B, S, S, 3] SAM-normalised pixels -> [B, g, g, C]."""
        return self.image_encoder(pixels)

    def predict(self, image_embedding, points_xy, labels, mask_input=None):
        """image_embedding [1, g, g, C]; points_xy [P, N, 2]; labels [P, N]
        -> (low-res mask logits [P, T, 4g, 4g], iou [P, T])."""
        sparse, dense = self.prompt_encoder(points_xy, labels, mask_input)
        return self.mask_decoder(image_embedding, self.prompt_encoder.dense_pe(), sparse, dense)

    def forward(self, pixels, points_xy, labels):
        return self.predict(self.encode_image(pixels), points_xy, labels)


# --------------------------------------------------------------------------
# Host-side pre/postprocessing (SamPredictor)
# --------------------------------------------------------------------------


def _resized_hw(hw, img_size: int):
    h, w = hw
    scale = img_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def preprocess_np(image_rgb_uint8: np.ndarray, img_size: int):
    """Longest-side resize (PIL bilinear on uint8, as ResizeLongestSide),
    normalise, pad bottom/right.  Returns ([1, S, S, 3] float32, (new_h,
    new_w) the unpadded content size)."""
    from ..data.image import resize_bilinear_pil

    nh, nw = _resized_hw(image_rgb_uint8.shape[:2], img_size)
    resized = resize_bilinear_pil(np.asarray(image_rgb_uint8, np.uint8), nh, nw)
    x = (resized.astype(np.float32) - np.asarray(SAM_PIXEL_MEAN, np.float32)) \
        / np.asarray(SAM_PIXEL_STD, np.float32)
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:nh, :nw] = x
    return out[None], (nh, nw)


def transform_coords_np(coords_xy, orig_hw, img_size: int):
    """Original-image pixel coords -> resized-image coords, +0.5 centred
    (``ResizeLongestSide.apply_coords`` against the rounded resized size,
    then ``_embed_points``' shift)."""
    h, w = orig_hw
    nh, nw = _resized_hw(orig_hw, img_size)
    c = np.asarray(coords_xy, np.float32).copy()
    c[..., 0] = c[..., 0] * (nw / w)
    c[..., 1] = c[..., 1] * (nh / h)
    return c + 0.5


def postprocess_masks(low_res_logits: torch.Tensor, input_hw, orig_hw, img_size: int):
    """[P, T, 4g, 4g] logits -> [P, T, H, W] at the original resolution:
    bilinear to ``img_size``, crop the padding, bilinear to the original
    size, both antialiased as ``jax.image.resize`` is."""
    x = F.interpolate(low_res_logits, (img_size, img_size), mode="bilinear",
                      align_corners=False, antialias=True)
    x = x[:, :, :input_hw[0], :input_hw[1]]
    return F.interpolate(x, tuple(orig_hw), mode="bilinear", align_corners=False,
                         antialias=True)


def postprocess_masks_np(low_res_logits, input_hw, orig_hw, img_size: int):
    """``postprocess_masks`` of a numpy array, on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(low_res_logits, np.float32))
    return postprocess_masks(x, input_hw, orig_hw, img_size).numpy()
