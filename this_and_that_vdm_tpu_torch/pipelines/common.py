"""Shared pipeline stages (counterpart of ``pipelines/common.py``):
CLIP preprocessing, the joint (78, D) LayerNorm, CFG batching, add-time ids,
the per-frame guidance linspace, chunked temporal decode and postprocess."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.resize import resize_with_antialiasing

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(image_m11: torch.Tensor) -> torch.Tensor:
    """[-1,1] ``[B, H, W, 3]`` -> CLIP-normalised ``[B, 224, 224, 3]``."""
    chw = resize_with_antialiasing(image_m11.permute(0, 3, 1, 2), (224, 224))
    chw = (chw + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=chw.dtype, device=chw.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, dtype=chw.dtype, device=chw.device).reshape(1, 3, 1, 1)
    return ((chw - mean) / std).permute(0, 2, 3, 1)


def joint_layer_norm(states: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``nn.LayerNorm((78, 1024))``: identity affine,
    statistics over the last TWO axes jointly."""
    x = states.float()
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps)).to(states.dtype)


def build_encoder_hidden_states(image_embeds: torch.Tensor,
                                text_states: Optional[torch.Tensor]) -> torch.Tensor:
    """[text tokens; image token], then the joint layer norm when text is used."""
    states = image_embeds[:, None, :]
    if text_states is not None:
        states = joint_layer_norm(torch.cat([text_states.to(states.dtype), states], dim=1))
    return states


def cfg_concat(cond: torch.Tensor, mode: str = "standard") -> torch.Tensor:
    """``standard``: [zeros; cond]; ``ip2p_states``: [cond; zeros; zeros];
    ``ip2p_image``: [cond; cond; zeros]."""
    zeros = torch.zeros_like(cond)
    if mode == "standard":
        return torch.cat([zeros, cond], dim=0)
    if mode == "ip2p_states":
        return torch.cat([cond, zeros, zeros], dim=0)
    if mode == "ip2p_image":
        return torch.cat([cond, cond, zeros], dim=0)
    raise ValueError(mode)


def get_add_time_ids(fps_minus_one: float, motion_bucket_id: float,
                     noise_aug_strength: float, batch: int, cfg_mult: int,
                     device=None) -> torch.Tensor:
    ids = torch.tensor([[fps_minus_one, motion_bucket_id, noise_aug_strength]],
                       dtype=torch.float32, device=device)
    return ids.repeat(batch * cfg_mult, 1)


def guidance_linspace(min_scale: float, max_scale: float, num_frames: int,
                      batch: int, device=None) -> torch.Tensor:
    g = torch.linspace(min_scale, max_scale, num_frames, dtype=torch.float32, device=device)
    return g[None, :, None, None, None].expand(batch, num_frames, 1, 1, 1)


def decode_latents_chunked(vae_decode, latents: torch.Tensor, scaling_factor: float,
                           decode_chunk_size: int) -> torch.Tensor:
    """Chunked temporal-VAE decode: the frame axis is split per clip (never
    across clips) into chunks of ``decode_chunk_size``, the last one ragged;
    chunk boundaries are part of the numerics (the temporal convs mix
    everything within a chunk)."""
    z = latents / scaling_factor
    outs = [vae_decode(z[:, i: i + decode_chunk_size])
            for i in range(0, latents.shape[1], decode_chunk_size)]
    return torch.cat(outs, dim=1)  # [B, F, H, W, 3]


def postprocess_frames(frames_m11: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1] float32."""
    return torch.clamp(frames_m11.float() / 2.0 + 0.5, 0.0, 1.0)


def postprocess_frames_uint8(frames_m11: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> uint8 on the device (cast before the device->host copy)."""
    return torch.round(postprocess_frames(frames_m11) * 255.0).to(torch.uint8)
