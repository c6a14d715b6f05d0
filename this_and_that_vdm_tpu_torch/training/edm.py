"""EDM training-time transforms (counterpart of ``training/edm.py``).

    sigma  ~ exp(Normal(loc, scale))           loc=0.5  scale=1.4 (configs)
    noisy  = latents + eps * sigma
    input  = noisy / sqrt(sigma^2 + 1)                       (c_in)
    t      = 0.25 * ln(sigma)
    D      = pred * c_out + c_skip * noisy
             c_out  = -sigma / sqrt(sigma^2+1)
             c_skip = 1 / (sigma^2+1)
    loss   = mean_b[ mean_pix( w * (D - latents)^2 ) ],  w = (1+sigma^2)/sigma^2

Random draws come from an explicit ``torch.Generator``; every function that
draws also accepts the draw itself, so the tests hand both packages the same
numpy numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_sigmas(generator: Optional[torch.Generator], batch: int, loc: float = 0.5,
                  scale: float = 1.4, normal: Optional[torch.Tensor] = None,
                  device=None) -> torch.Tensor:
    """Log-normal sigma draw, fp32 ``[B]``; ``normal`` replaces the N(0, 1)
    draw."""
    if normal is None:
        normal = torch.randn((batch,), generator=generator, device=device)
    return torch.exp(loc + scale * normal.float())


def edm_precondition(latents: torch.Tensor, noise: torch.Tensor, sigmas: torch.Tensor):
    """(noisy_latents, scaled_input, timesteps); ``sigmas`` ``[B]``."""
    s = sigmas.reshape(sigmas.shape[0], *([1] * (latents.dim() - 1)))
    noisy = latents + noise * s
    inp = noisy / torch.sqrt(s * s + 1.0)
    return noisy, inp, 0.25 * torch.log(sigmas)


def edm_loss(model_pred, noisy_latents, target_latents, sigmas) -> torch.Tensor:
    """Weighted EDM reconstruction MSE (fp32 scalar)."""
    s = sigmas.reshape(sigmas.shape[0], *([1] * (model_pred.dim() - 1))).float()
    pred, noisy = model_pred.float(), noisy_latents.float()
    target = target_latents.float()
    c_out = -s / torch.sqrt(s * s + 1.0)
    c_skip = 1.0 / (s * s + 1.0)
    denoised = pred * c_out + c_skip * noisy
    weight = (1.0 + s * s) / (s * s)
    per_sample = torch.mean((weight * (denoised - target) ** 2).reshape(target.shape[0], -1),
                            dim=1)
    return torch.mean(per_sample)


def conditioning_dropout(generator: Optional[torch.Generator], encoder_hidden_states,
                         conditional_latents, prob: float,
                         uniform: Optional[torch.Tensor] = None):
    """InstructPix2Pix-style dropout: one uniform ``p`` per sample zeroes the
    CLIP states when ``p < 2*prob`` and the image latents when
    ``prob <= p < 3*prob``; ``uniform`` replaces the draw."""
    b = encoder_hidden_states.shape[0]
    if uniform is None:
        uniform = torch.rand((b,), generator=generator, device=encoder_hidden_states.device)
    p = uniform.float()
    prompt_mask = (p < 2.0 * prob).reshape(b, 1, 1)
    states = torch.where(prompt_mask, torch.zeros_like(encoder_hidden_states),
                         encoder_hidden_states)
    image_keep = 1.0 - ((p >= prob) & (p < 3.0 * prob)).to(conditional_latents.dtype)
    image_keep = image_keep.reshape(b, *([1] * (conditional_latents.dim() - 1)))
    return states, conditional_latents * image_keep
