"""VGL inference pipeline: image + text + gesture raster -> video
(counterpart of ``pipelines/svd_controlnet.py``).

The VL pipeline plus the GestureNet ControlNet in the loop.  The VAE encode
of the (constant) gesture raster is hoisted out of the loop, once per call.
Supports ``controlnet_conditioning_scale``, ``control_guidance_start/end``
step gating, ``guess_mode`` (ControlNet on the conditional half only, with
zero residuals on the other branches) and the 3-way ``use_instructpix2pix``
CFG.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..schedulers import make_svd_schedule
from . import common
from .svd import StableVideoDiffusionPipeline, _Stage


class StableVideoDiffusionControlNetPipeline(StableVideoDiffusionPipeline):
    def __init__(self, unet, vae, image_encoder, controlnet, text_encoder=None):
        super().__init__(unet, vae, image_encoder, text_encoder)
        self.controlnet = controlnet

    def encode_condition_img(self, condition_img):
        """[F, H, W, 3] (or [B, F, H, W, 3]) in [0, 1] -> VAE latents; the
        raster enters the VAE in [0, 1], as the reference feeds it."""
        cond = torch.as_tensor(condition_img, device=self.device).float()
        lat = self.vae.encode_mode(cond.reshape((-1,) + cond.shape[-3:])).float()
        return lat.reshape(cond.shape[:-3] + lat.shape[1:])

    def denoise(self, latents, states_cfg, img_lat_cfg, cond_latents, add_ids, guidance,
                num_steps: int, cond_scale: float, ctrl_start: float, ctrl_end: float,
                guess_mode: bool, ip2p: bool, image_guidance_scale: float):
        dev = latents.device
        sched = make_svd_schedule(num_steps)
        mult = 3 if ip2p else 2
        b, f = latents.shape[:2]
        keep = [1.0 - float(i / num_steps < ctrl_start or (i + 1) / num_steps > ctrl_end)
                for i in range(num_steps)]
        img_lat = img_lat_cfg[:, None].expand(-1, f, -1, -1, -1)
        guess = guess_mode and mult > 1
        cn_batch = 1 if guess else mult
        if cond_latents.dim() == 4:  # shared [F, h, w, 4] (reference API)
            cn_cond = cond_latents[None].repeat(b * cn_batch, 1, 1, 1, 1)
        else:  # per-clip [B, F, h, w, 4]; CFG layout is branch-major blocks of B
            cn_cond = cond_latents.repeat(cn_batch, 1, 1, 1, 1)
        # the branch the ControlNet runs on in guess mode: cond is last in the
        # standard [uncond; cond] layout, first in ip2p [cond; uncond_t; uncond_i]
        cn_rows = slice(0, b) if ip2p else slice(b * (mult - 1), b * mult)

        x = latents * sched.init_noise_sigma
        for i in range(num_steps):
            inp = sched.scale_model_input(torch.cat([x] * mult, dim=0), i)
            inp = torch.cat([inp, img_lat], dim=-1)
            t = torch.tensor(sched.timesteps[i], device=dev)
            scale = cond_scale * keep[i]
            if guess:
                res, mid = self.controlnet(inp[cn_rows], t, states_cfg[cn_rows],
                                           add_ids[cn_rows], cn_cond,
                                           conditioning_scale=scale, guess_mode=True,
                                           context_clips=b)

                def pad(r):
                    zeros = [torch.zeros_like(r)] * (mult - 1)
                    return torch.cat([r] + zeros if ip2p else zeros + [r], dim=0)

                res, mid = tuple(pad(r) for r in res), pad(mid)
            else:
                res, mid = self.controlnet(inp, t, states_cfg, add_ids, cn_cond,
                                           conditioning_scale=scale, guess_mode=guess_mode,
                                           context_clips=b)
            pred = self.unet(inp, t, states_cfg, add_ids, down_block_additional_residuals=res,
                             mid_block_additional_residual=mid, context_clips=b)
            if ip2p:
                p_first, p_cond, p_uncond = pred.chunk(3, dim=0)
                pred = (p_uncond + guidance * (p_cond - p_uncond)
                        + image_guidance_scale * (p_cond - p_first))
            else:
                p_uncond, p_cond = pred.chunk(2, dim=0)
                pred = p_uncond + guidance * (p_cond - p_uncond)
            x = sched.step(pred, i, x)
        return x

    @torch.no_grad()
    def __call__(self, image, condition_img, prompt_ids=None, num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, fps: int = 7, motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02, decode_chunk_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, latents=None,
                 image_noise=None, controlnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0, control_guidance_end: float = 1.0,
                 guess_mode: bool = False, use_instructpix2pix: bool = False,
                 image_guidance_scale: float = 7.5, output_type: str = "np",
                 trace: Optional[dict] = None):
        """``image`` [B, H, W, 3] in [-1, 1]; ``condition_img`` the gesture
        raster [F, H, W, 3] in [0, 1]; ``prompt_ids`` [B, 77] int."""
        dev = self.device
        decode_chunk_size = decode_chunk_size or num_frames
        image, image_noise, latents = self._draws(image, generator, image_noise, latents,
                                                  num_frames)
        b = image.shape[0]
        ids = None if prompt_ids is None else torch.as_tensor(prompt_ids, device=dev)
        mode = "ip2p" if use_instructpix2pix else "standard"
        with _Stage(trace, "cond_encode", dev):
            states_cfg, img_lat_cfg = self.encode_conditioning(
                image, ids, noise_aug_strength * image_noise, mode)
        with _Stage(trace, "gesture_encode", dev):
            cond_latents = self.encode_condition_img(condition_img)
        mult = 3 if use_instructpix2pix else 2
        add_ids = common.get_add_time_ids(fps - 1, motion_bucket_id, noise_aug_strength,
                                          b, mult, dev)
        guidance = common.guidance_linspace(min_guidance_scale, max_guidance_scale,
                                            num_frames, b, dev)
        with _Stage(trace, "denoise", dev):
            x = self.denoise(latents, states_cfg, img_lat_cfg, cond_latents, add_ids,
                             guidance, num_inference_steps,
                             float(controlnet_conditioning_scale),
                             float(control_guidance_start), float(control_guidance_end),
                             guess_mode, use_instructpix2pix, float(image_guidance_scale))
        return self._finish(x, output_type, decode_chunk_size, trace)
