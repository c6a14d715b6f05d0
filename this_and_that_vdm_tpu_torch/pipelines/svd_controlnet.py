"""VGL inference pipeline: image + text + gesture raster -> video
(counterpart of ``pipelines/svd_controlnet.py``).

The VL pipeline plus the GestureNet ControlNet in the loop.  The VAE encode
of the (constant) gesture raster is hoisted out of the loop, once per call.
Supports ``controlnet_conditioning_scale``, ``control_guidance_start/end``
step gating, ``guess_mode`` (ControlNet on the conditional half only, with
zero residuals on the other branches) and the 3-way ``use_instructpix2pix``
CFG.  On a serving mesh (``place_on_mesh``, see ``pipelines/svd.py``) each
CFG branch runs the ControlNet and the UNet on its own device; in guess mode
only the conditional branch's device runs the ControlNet.  ``bake_params``
and the step graphs: see ``pipelines/svd.py`` (the ``denoise_cn`` key adds
``ip2p`` and ``guess_mode``; the per-step ControlNet scale and the image
guidance scale are columns of the step table); so are the spans, with
``pipeline.gesture_encode`` opened in ``encode_condition_img``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..schedulers import make_svd_schedule
from ..utils import profiling
from . import common
from .svd import StableVideoDiffusionPipeline, cfg_parts, denoise_table


class StableVideoDiffusionControlNetPipeline(StableVideoDiffusionPipeline):
    _MODULES = StableVideoDiffusionPipeline._MODULES + ("controlnet",)

    def __init__(self, unet, vae, image_encoder, controlnet, text_encoder=None,
                 bake_params: bool = False):
        super().__init__(unet, vae, image_encoder, text_encoder, bake_params)
        self.controlnet = controlnet

    def encode_condition_img(self, condition_img, trace: Optional[dict] = None):
        """[F, H, W, 3] (or [B, F, H, W, 3]) in [0, 1] -> VAE latents; the
        raster enters the VAE in [0, 1], as the reference feeds it."""
        with profiling.span("pipeline.gesture_encode", self.device, trace=trace):
            cond = torch.as_tensor(condition_img, device=self.device).float()
            lat = self.vae.encode_mode(cond.reshape((-1,) + cond.shape[-3:])).float()
            return lat.reshape(cond.shape[:-3] + lat.shape[1:])

    def denoise(self, latents, states_cfg, img_lat_cfg, cond_latents, add_ids, guidance,
                num_steps: int, cond_scale: float, ctrl_start: float, ctrl_end: float,
                guess_mode: bool, ip2p: bool, image_guidance_scale: float, branches=None,
                trace: Optional[dict] = None):
        """The Euler loop; ``branches``: the replicas of the CFG branches
        (one a branch) on a serving mesh, else None.  The single-device loop
        is ``_denoise_loop`` over ``denoise_step`` (baked: a replayed CUDA
        graph); the CFG-split loop runs eagerly (``denoise.eager``)."""
        if branches is not None and len(branches) == (3 if ip2p else 2):
            with profiling.span("denoise.eager", latents.device, trace=trace, key="denoise",
                                steps=num_steps, batch=latents.shape[0],
                                branches=len(branches)):
                return self._denoise_split(branches, latents, states_cfg, img_lat_cfg,
                                           cond_latents, add_ids, guidance, num_steps,
                                           cond_scale, ctrl_start, ctrl_end, guess_mode, ip2p,
                                           image_guidance_scale)
        b = latents.shape[0]
        mult = 3 if ip2p else 2
        keep = [1.0 - float(i / num_steps < ctrl_start or (i + 1) / num_steps > ctrl_end)
                for i in range(num_steps)]
        cn_batch = 1 if guess_mode else mult
        if cond_latents.dim() == 4:  # shared [F, h, w, 4] (reference API)
            cn_cond = cond_latents[None].repeat(b * cn_batch, 1, 1, 1, 1)
        else:  # per-clip [B, F, h, w, 4]; CFG layout is branch-major blocks of B
            cn_cond = cond_latents.repeat(cn_batch, 1, 1, 1, 1)
        table, sigma0 = denoise_table(num_steps, latents.device,
                                      cn_scale=[cond_scale * k for k in keep],
                                      image_guidance_scale=image_guidance_scale)
        inputs = dict(states=states_cfg, img_lat=img_lat_cfg, add_ids=add_ids,
                      guidance=guidance, cn_cond=cn_cond)
        return self._denoise_loop("denoise_cn", latents, table, sigma0, inputs, ip2p=ip2p,
                                  guess_mode=guess_mode, trace=trace)

    def _denoise_split(self, branches, latents, states_cfg, img_lat_cfg, cond_latents, add_ids,
                       guidance, num_steps, cond_scale, ctrl_start, ctrl_end, guess_mode, ip2p,
                       image_guidance_scale):
        """:meth:`denoise` with CFG branch ``j`` on ``branches[j]``: the
        predictions meet on this (the first) device for the combine."""
        dev = latents.device
        sched = make_svd_schedule(num_steps)
        b, f = latents.shape[:2]
        keep = [1.0 - float(i / num_steps < ctrl_start or (i + 1) / num_steps > ctrl_end)
                for i in range(num_steps)]
        cn_cond = cond_latents[None].repeat(b, 1, 1, 1, 1) if cond_latents.dim() == 4 \
            else cond_latents
        img_lat = img_lat_cfg[:, None].expand(-1, f, -1, -1, -1)
        parts = cfg_parts(branches, b, dict(states=states_cfg, img_lat=img_lat, add_ids=add_ids))
        # guess mode: the ControlNet on the conditional branch alone (last in
        # the standard layout, first in ip2p), over its own rows
        cn_branch = 0 if ip2p else len(parts) - 1
        x = latents * sched.init_noise_sigma
        for i in range(num_steps):
            scale = cond_scale * keep[i]
            preds = []
            for j, (pipe, rows, ctx) in enumerate(parts):
                d = pipe.device
                inp = torch.cat([sched.scale_model_input(x.to(d), i), rows["img_lat"]], dim=-1)
                t = torch.tensor(sched.timesteps[i], device=d)
                res = mid = None
                if not guess_mode or j == cn_branch:
                    res, mid = pipe.controlnet(inp, t, rows["states"], rows["add_ids"],
                                               cn_cond.to(d), conditioning_scale=scale,
                                               guess_mode=guess_mode,
                                               context_clips=b if guess_mode else ctx)
                preds.append(pipe.unet(inp, t, rows["states"], rows["add_ids"],
                                       down_block_additional_residuals=res,
                                       mid_block_additional_residual=mid, context_clips=ctx))
            preds = [q.to(dev) for q in preds]
            if ip2p:
                p_first, p_cond, p_uncond = preds
                pred = (p_uncond + guidance * (p_cond - p_uncond)
                        + image_guidance_scale * (p_cond - p_first))
            else:
                p_uncond, p_cond = preds
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
        with profiling.span("pipeline.call", batch=len(image)):
            dev = self.device
            decode_chunk_size = decode_chunk_size or num_frames
            image, image_noise, latents = self._draws(image, generator, image_noise, latents,
                                                      num_frames)
            ids = None if prompt_ids is None else torch.as_tensor(prompt_ids, device=dev)
            cond = torch.as_tensor(condition_img, device=dev).float()
            per_clip = dict(image=image, image_noise=image_noise, latents=latents)
            shared = {}
            if ids is not None:
                per_clip["ids"] = ids
            # per-clip gestures [B, F, H, W, 3] split with the clips; the shared
            # [F, H, W, 3] raster goes to every part
            (per_clip if cond.dim() == 5 else shared)["cond"] = cond

            def run(pipe, branches, image, image_noise, latents, cond, ids=None, trace=None):
                return pipe._generate(
                    branches, image, ids, image_noise, latents, cond, num_frames,
                    num_inference_steps, min_guidance_scale, max_guidance_scale, fps,
                    motion_bucket_id, noise_aug_strength, float(controlnet_conditioning_scale),
                    float(control_guidance_start), float(control_guidance_end), guess_mode,
                    use_instructpix2pix, float(image_guidance_scale), trace)

            return self._serve(run, per_clip, shared, output_type, decode_chunk_size, trace)

    def _generate(self, branches, image, ids, image_noise, latents, cond, num_frames, steps,
                  min_guidance_scale, max_guidance_scale, fps, motion_bucket_id,
                  noise_aug_strength, cond_scale, ctrl_start, ctrl_end, guess_mode, ip2p,
                  image_guidance_scale, trace):
        """Encode and denoise the clips of one part -> final latents."""
        dev = self.device
        b = image.shape[0]
        mode = "ip2p" if ip2p else "standard"
        states_cfg, img_lat_cfg = self.encode_conditioning(
            image, ids, noise_aug_strength * image_noise, mode, trace=trace)
        cond_latents = self.encode_condition_img(cond, trace=trace)
        mult = 3 if ip2p else 2
        add_ids = common.get_add_time_ids(fps - 1, motion_bucket_id, noise_aug_strength,
                                          b, mult, dev)
        guidance = common.guidance_linspace(min_guidance_scale, max_guidance_scale,
                                            num_frames, b, dev)
        return self.denoise(latents, states_cfg, img_lat_cfg, cond_latents, add_ids,
                            guidance, steps, cond_scale, ctrl_start, ctrl_end, guess_mode,
                            ip2p, image_guidance_scale, branches, trace=trace)
