"""The reference VGL clip: image + prompt ids + gesture raster -> uint8 frames.

Written from the SVD img2vid pipeline and This&That's
``StableVideoDiffusionControlNetPipeline``: CLIP preprocessing (skimage
Gaussian antialias, then bicubic with aligned corners), the image embedding
joined to the text states under one LayerNorm over both axes, the VAE
latent of the noise-augmented first frame, classifier-free guidance as the
batch pair ``[uncond; cond]`` with a per-frame linear guidance ramp, Euler
steps on the EDM (Karras) sigma ramp with v-prediction, the gesture raster's
VAE latents through the ControlNet at every step, the chunked temporal
decode and the rounding to uint8.

``server_draws`` redoes the noise that a served request draws from its own
seed: a ``torch.Generator`` on the card seeded with the request's seed,
image noise ``[1, H, W, 3]`` first, then latents ``[1, F, H/8, W/8, 4]``.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x):
    x = np.abs(x)
    a = -0.75
    return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                    np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]``: a reflect-padded Gaussian blur with
    sigma = max((n_in / n_out - 1) / 2, 0.001) and an odd kernel of
    max(4 sigma, 3) taps, then bicubic with aligned corners."""
    sigma = max((n_in / n_out - 1.0) / 2.0, 0.001)
    ks = int(max(4.0 * sigma, 3))
    ks += 1 - ks % 2
    x = np.arange(ks) - ks // 2
    g = np.exp(-x ** 2 / (2 * sigma ** 2))
    g /= g.sum()
    blur = np.zeros((n_in, n_in))
    period = 2 * (n_in - 1)
    for i in range(n_in):
        for k in range(ks):
            j = abs(i - (ks - 1) // 2 + k) % period
            blur[i, period - j if j >= n_in else j] += g[k]
    interp = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        j0 = int(np.floor(src))
        for off in (-1, 0, 1, 2):
            interp[i, min(max(j0 + off, 0), n_in - 1)] += _cubic(off - (src - j0))
    return interp @ blur


def clip_pixels(image):
    """[B, H, W, 3] in [-1, 1] -> CLIP-normalised [B, 224, 224, 3]."""
    mh = torch.tensor(resize_matrix(image.shape[1], 224), dtype=torch.float32,
                      device=image.device)
    mw = torch.tensor(resize_matrix(image.shape[2], 224), dtype=torch.float32,
                      device=image.device)
    out = torch.einsum("oh,bhwc,pw->bopc", mh, image.float(), mw)
    mean = torch.tensor(CLIP_MEAN, device=image.device)
    std = torch.tensor(CLIP_STD, device=image.device)
    return ((out + 1.0) / 2.0 - mean) / std


def encoder_states(models, image, ids):
    """[B, 78, 1024]: the 77 text states and the image token under one
    LayerNorm over both axes (no affine)."""
    img = models["image_encoder"](clip_pixels(image))[:, None]
    states = torch.cat([models["text_encoder"](ids), img], dim=1)
    mean = states.mean(dim=(1, 2), keepdim=True)
    var = states.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (states - mean) * torch.rsqrt(var + 1e-5)


def karras_sigmas(steps: int, lo=0.002, hi=700.0, rho=7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, steps)
    s = (hi ** (1 / rho) + ramp * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
    return np.concatenate([s, [0.0]])


def server_draws(seed: int, frames: int, h: int, w: int, device):
    g = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn((1, h, w, 3), generator=g, device=device)
    latents = torch.randn((1, frames, h // 8, w // 8, 4), generator=g, device=device)
    return noise, latents


@torch.no_grad()
def vgl_clip(models, image, raster, ids, seed, s):
    """One clip as the server serves it. ``image`` [H, W, 3] in [-1, 1],
    ``raster`` [F, H, W, 3] in [0, 1], ``ids`` [77]; ``s`` the sampling
    settings of the configuration.  -> uint8 [F, H, W, 3]."""
    dev = image.device
    frames, steps = s["num_frames"], s["num_inference_steps"]
    h, w = image.shape[:2]
    image = image[None].float()
    noise, lat = server_draws(seed, frames, h, w, dev)
    vae = models["vae"]
    states = encoder_states(models, image, ids[None])
    states = torch.cat([torch.zeros_like(states), states])
    first = vae.encode_mode(image + s["noise_aug_strength"] * noise)
    img_lat = torch.cat([torch.zeros_like(first), first])[:, None].expand(-1, frames, -1, -1, -1)
    gesture = vae.encode_mode(raster.float())[None].expand(2, -1, -1, -1, -1)
    add_ids = torch.tensor([[s["fps"] - 1, s["motion_bucket_id"], s["noise_aug_strength"]]] * 2,
                           device=dev)
    guidance = torch.linspace(s["min_guidance_scale"], s["max_guidance_scale"], frames,
                              device=dev)[None, :, None, None, None]
    sig = karras_sigmas(steps)
    x = lat * float(np.sqrt(sig.max() ** 2 + 1.0))
    for i in range(steps):
        sigma, nxt = float(sig[i]), float(sig[i + 1])
        inp = torch.cat([torch.cat([x, x]) / np.sqrt(sigma ** 2 + 1.0), img_lat], dim=-1)
        t = torch.tensor(0.25 * np.log(sigma), device=dev)
        res, mid = models["gesturenet"](inp, t, states, add_ids, gesture,
                                         s["controlnet_conditioning_scale"])
        out = models["unet"](inp, t, states, add_ids, res, mid)
        uncond, cond = out.chunk(2)
        v = uncond + guidance * (cond - uncond)
        denoised = v * (-sigma / np.sqrt(sigma ** 2 + 1.0)) + x / (sigma ** 2 + 1.0)
        x = x + (x - denoised) / sigma * (nxt - sigma)
    z = x / vae.config.scaling_factor
    chunk = s["decode_chunk_size"]
    video = torch.cat([vae.decode(z[:, i:i + chunk]) for i in range(0, frames, chunk)], dim=1)
    return torch.round(torch.clamp(video[0] / 2.0 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)
