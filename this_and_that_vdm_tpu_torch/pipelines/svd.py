"""VL inference pipeline: image (+ text) -> video (counterpart of
``pipelines/svd.py``).

Conditioning encode (CLIP vision + text, joint LayerNorm, VAE encode of the
noise-augmented first frame), a Python loop of Euler-EDM steps with the CFG
pair as batch 2 and per-frame linspace guidance, chunked temporal-VAE decode,
postprocess.  Random draws come from an explicit ``torch.Generator``;
``latents=`` and ``image_noise=`` inject them instead (the tests hand both
packages the same numpy draws).

``trace``: an optional dict; when given, each stage ends in a device
synchronise and its wall seconds are recorded under the stage's name
(``cond_encode``, ``gesture_encode``, ``denoise``, ``decode``,
``uint8_host``), with the final latents under ``latents``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..schedulers import make_svd_schedule
from . import common


class _Stage:
    """Times one pipeline stage into ``trace`` (ends in a device sync)."""

    def __init__(self, trace: Optional[dict], name: str, device: torch.device):
        self.trace, self.name, self.device = trace, name, device

    def __enter__(self):
        if self.trace is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.trace is not None and exc[0] is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.trace[self.name] = time.perf_counter() - self.t0
        return False


class StableVideoDiffusionPipeline:
    """Holds the modules; ``__call__`` mirrors the reference API."""

    def __init__(self, unet, vae, image_encoder, text_encoder=None):
        self.unet, self.vae = unet, vae
        self.image_encoder, self.text_encoder = image_encoder, text_encoder

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _draws(self, image, generator, image_noise, latents, num_frames):
        """Inputs as fp32 tensors on the device; missing noise drawn from
        ``generator`` (image noise first, then latents)."""
        dev = self.device
        image = torch.as_tensor(image, device=dev).float()
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        b, h, w = image.shape[:3]
        if image_noise is None:
            image_noise = torch.randn(image.shape, generator=generator, device=dev)
        if latents is None:
            latents = torch.randn((b, num_frames, h // 8, w // 8, 4), generator=generator,
                                  device=dev)
        return (image, torch.as_tensor(image_noise, device=dev).float(),
                torch.as_tensor(latents, device=dev).float())

    def encode_conditioning(self, image_m11, input_ids, noise_img, mode: str = "standard"):
        """-> (encoder states with CFG batching, image latents with CFG batching)."""
        px = common.clip_preprocess(image_m11)
        image_embeds = self.image_encoder(px)
        text_states = None
        if self.text_encoder is not None and input_ids is not None:
            text_states = self.text_encoder(input_ids)
        states = common.build_encoder_hidden_states(image_embeds, text_states)
        lat = self.vae.encode_mode(image_m11 + noise_img).float()
        if mode == "ip2p":
            return common.cfg_concat(states, "ip2p_states"), common.cfg_concat(lat, "ip2p_image")
        return common.cfg_concat(states), common.cfg_concat(lat)

    def _finish(self, latents, output_type: str, decode_chunk_size: int, trace):
        if trace is not None:
            trace["latents"] = latents
        if output_type == "latent":
            return latents.cpu().numpy()
        with _Stage(trace, "decode", self.device):
            frames = common.decode_latents_chunked(
                self.vae.decode, latents, self.vae.config.scaling_factor, decode_chunk_size)
        with _Stage(trace, "uint8_host", self.device):
            if output_type == "uint8":
                out = common.postprocess_frames_uint8(frames).cpu().numpy()
            else:
                out = common.postprocess_frames(frames).cpu().numpy()
        return out

    @torch.no_grad()
    def __call__(self, image, prompt_ids=None, num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, fps: int = 7, motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02, decode_chunk_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, latents=None,
                 image_noise=None, output_type: str = "np", trace: Optional[dict] = None):
        """``image`` [B, H, W, 3] in [-1, 1]; ``prompt_ids`` [B, 77] int."""
        dev = self.device
        decode_chunk_size = decode_chunk_size or num_frames
        image, image_noise, latents = self._draws(image, generator, image_noise, latents,
                                                  num_frames)
        b = image.shape[0]
        ids = None if prompt_ids is None else torch.as_tensor(prompt_ids, device=dev)
        with _Stage(trace, "cond_encode", dev):
            states_cfg, img_lat_cfg = self.encode_conditioning(
                image, ids, noise_aug_strength * image_noise)
        add_ids = common.get_add_time_ids(fps - 1, motion_bucket_id, noise_aug_strength,
                                          b, 2, dev)
        guidance = common.guidance_linspace(min_guidance_scale, max_guidance_scale,
                                            num_frames, b, dev)
        with _Stage(trace, "denoise", dev):
            sched = make_svd_schedule(num_inference_steps)
            img_lat = img_lat_cfg[:, None].expand(-1, num_frames, -1, -1, -1)
            x = latents * sched.init_noise_sigma
            for i in range(num_inference_steps):
                inp = sched.scale_model_input(torch.cat([x, x], dim=0), i)
                inp = torch.cat([inp, img_lat], dim=-1)
                pred = self.unet(inp, torch.tensor(sched.timesteps[i], device=dev),
                                 states_cfg, add_ids, context_clips=b)
                uncond, cond = pred.chunk(2, dim=0)
                x = sched.step(uncond + guidance * (cond - uncond), i, x)
        return self._finish(x, output_type, decode_chunk_size, trace)

