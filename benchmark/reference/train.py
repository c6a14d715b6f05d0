"""The reference VL finetune step: EDM loss of SVD's UNet and 8-bit AdamW.

Written from This&That's ``train_svd.py`` (the VL trainer): the frozen VAE
latents of every frame (times the scaling factor), the VAE latent of the
noise-augmented first frame repeated over the frames, sigma = exp(mean +
std * N(0, 1)), noisy = latents + noise * sigma, the UNet on
``cat(noisy / sqrt(sigma^2 + 1), first-frame latents)`` at t = ln(sigma) / 4
with the CLIP states (the image embedding of the clean first frame joined
to the text states), InstructPix2Pix conditioning dropout (one uniform per
clip zeroes the states below 2p and the first-frame latents in [p, 3p)),
and the loss mean(w * (D - latents)^2) with D = c_out * pred + c_skip *
noisy, w = (1 + sigma^2) / sigma^2.  The random draws are handed in.

The optimizer is AdamW with block-quantised 8-bit moments: each moment is
kept per 256-element block as an absmax scale and one code per element, of
a log codebook of magnitudes 10 ** linspace(-7, 0, n) (n = 127 signed for
the first moment, 0 and the magnitudes with both signs; n = 255 unsigned
for the second), each value taken to its nearest code; the step is the
bias-corrected ``m / (sqrt(v) + eps)`` of the unquantised new moments, plus
the weight decay times the parameter, times -lr.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import ops
from .pipeline import encoder_states

BLOCK = 256


def codebook(signed: bool) -> torch.Tensor:
    if signed:
        mags = 10.0 ** np.linspace(-7.0, 0.0, 127)
        table = np.concatenate([-mags[::-1], [0.0], mags, [1.0]])  # code 255 unused
    else:
        table = np.concatenate([[0.0], 10.0 ** np.linspace(-7.0, 0.0, 255)])
    return torch.tensor(table, dtype=torch.float64)


def quantize(x: torch.Tensor, signed: bool):
    """Flat fp32 -> (codes [nb * 256] uint8, absmax [nb])."""
    blocks = torch.nn.functional.pad(x.reshape(-1).float(), (0, (-x.numel()) % BLOCK))
    blocks = blocks.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1)
    v = (blocks / torch.where(scale > 0, scale, 1.0)[:, None]).double()
    table = codebook(signed).to(x.device)[:255 if signed else 256]
    mids = (table[1:] + table[:-1]) / 2
    codes = torch.searchsorted(mids, v.contiguous(), right=True)
    return codes.to(torch.uint8).reshape(-1), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, signed: bool, numel: int):
    table = codebook(signed).to(codes.device).float()
    return (table[codes.long()].reshape(-1, BLOCK) * scale[:, None]).reshape(-1)[:numel]


class Adam8bit:
    def __init__(self, params: dict, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.wd, self.count = eps, weight_decay, 0
        zero = lambda p, s: quantize(torch.zeros(p.numel(), device=p.device), s)  # noqa: E731
        self.m = {k: zero(p, True) for k, p in params.items()}
        self.v = {k: zero(p, False) for k, p in params.items()}

    def first_moment(self, name: str) -> torch.Tensor:
        return dequantize(*self.m[name], True, self.params[name].numel())

    @torch.no_grad()
    def step(self, grads: dict):
        lr = float(self.lr(self.count))
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g, n = grads[k].reshape(-1).float(), p.numel()
            m = self.b1 * dequantize(*self.m[k], True, n) + (1 - self.b1) * g
            v = self.b2 * dequantize(*self.v[k], False, n) + (1 - self.b2) * g * g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p.reshape(-1)
            p.add_((-lr * upd).reshape(p.shape))
            self.m[k], self.v[k] = quantize(m, True), quantize(v, False)


def warmup_constant(lr: float, warmup: int):
    return lambda count: lr if warmup <= 0 or count >= warmup else lr * count / warmup


def vl_loss(models, t: dict, batch: dict, draws: dict, frozen_precision=None):
    """The EDM loss of one batch (``batch``: video_frames [B, F, H, W, 3] in
    [-1, 1], prompt_ids [B, 77], motion_bucket_id [B]); ``frozen_precision``:
    the precision of the frozen encodes (default: that of the step)."""
    vae, unet = models["vae"], models["unet"]
    frames = batch["video_frames"].float()
    b, f = frames.shape[:2]
    frozen = ops.precision(frozen_precision) if frozen_precision else contextlib.nullcontext()
    with torch.no_grad(), frozen:
        lat = vae.encode_mode(frames.flatten(0, 1))
        latents = lat.reshape(b, f, *lat.shape[1:]) * vae.config.scaling_factor
        first = frames[:, 0] + draws["aug"] * t["train_noise_aug_strength"]
        cond_lat = vae.encode_mode(first)[:, None].repeat(1, f, 1, 1, 1)
        states = encoder_states(models, frames[:, 0], batch["prompt_ids"])
        p = draws["dropout"].float()
        prob = t["conditioning_dropout_prob"]
        states = torch.where((p < 2 * prob).reshape(b, 1, 1), 0.0, states)
        keep = 1.0 - ((p >= prob) & (p < 3 * prob)).float()
        cond_lat = cond_lat * keep.reshape(b, 1, 1, 1, 1)
    sigmas = torch.exp(t["noise_mean"] + t["noise_std"] * draws["sigma"].float())
    s = sigmas.reshape(b, 1, 1, 1, 1)
    noisy = latents + draws["noise"] * s
    inp = torch.cat([noisy / torch.sqrt(s * s + 1), cond_lat], dim=-1)
    ids = torch.stack([torch.full((b,), float(t["process_fps"]), device=frames.device),
                       batch["motion_bucket_id"].float(),
                       torch.full((b,), t["train_noise_aug_strength"], device=frames.device)], -1)
    pred = unet(inp, 0.25 * torch.log(sigmas), states, ids)
    denoised = pred * (-s / torch.sqrt(s * s + 1)) + noisy / (s * s + 1)
    weight = (1 + s * s) / (s * s)
    return (weight * (denoised - latents) ** 2).reshape(b, -1).mean(dim=1).mean()


def vl_steps(models, t: dict, batches, draws, frozen_precision=None):
    """The reference's steps over ``batches`` with ``draws``; ->
    (losses, per-leaf first-gradient norms from the state after step 1,
    per-leaf gradient norms of step 1, the optimizer)."""
    unet = models["unet"]
    params = dict(unet.named_parameters())
    opt = Adam8bit(params, warmup_constant(t["learning_rate"], t["lr_warmup_steps"]),
                   t["adam_beta1"], t["adam_beta2"], t["adam_epsilon"], t["adam_weight_decay"])
    losses, first_norms, grad_norms = [], None, None
    for i, (batch, d) in enumerate(zip(batches, draws)):
        loss = vl_loss(models, t, batch, d, frozen_precision)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        opt.step(grads)
        if i == 0:
            grad_norms = {k: float(g.float().norm()) for k, g in grads.items()}
            first_norms = {k: float(opt.first_moment(k).norm()) / (1 - opt.b1) for k in params}
        del grads
    return losses, first_norms, grad_norms, opt
