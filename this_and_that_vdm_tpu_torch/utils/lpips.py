"""LPIPS perceptual metric (AlexNet backbone), the port's counterpart of
``this_and_that_vdm_tpu/utils/lpips.py``:

    d(x, y) = sum_l mean_hw || w_l * (phi_l(x)^ - phi_l(y)^) ||_2^2

with phi_l the five relu outputs of torchvision's AlexNet ``features``
trunk (max-pools 3x3 / 2 after the first two), ^ the normalisation of each
pixel's channel vector to unit length (``+1e-10`` under the root), and w_l
the learned non-negative per-channel weights, after the ScalingLayer's
shift and scale of the [-1, 1] input.  The convolutions are the library's
(``nn.Conv2d``): the JAX LPIPS reaches no Pallas kernel.

Weights: ``lpips_params_from_torch(alexnet_state, lin_state)`` takes the
torchvision ``features.N.*`` state dict and the LPIPS ``lin{i}.model.1.weight``
heads (the two files the lpips package combines) and returns this module's
state dict.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# the LPIPS ScalingLayer (lpips/lpips.py)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet ``features``: (index, in, out, kernel, stride, pad)
_ALEX_CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
               (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))
CHANNELS = tuple(c[2] for c in _ALEX_CONVS)


class LPIPS(nn.Module):
    """LPIPS-alex distance ``[B]`` between two ``[B, H, W, 3]`` images in
    [-1, 1] (channels last, as the JAX module takes them)."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (_, cin, cout, k, s, p) in enumerate(_ALEX_CONVS):
            layers += [nn.Conv2d(cin, cout, k, s, p), nn.ReLU()]
            if i < 2:
                layers.append(nn.MaxPool2d(3, 2))
        self.features = nn.Sequential(*layers)  # conv indices 0, 3, 6, 8, 10
        self.lins = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c in CHANNELS])
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def _relu_outputs(self, x):
        x = (x.permute(0, 3, 1, 2) - self.shift) / self.scale
        feats = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                feats.append(x)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for gx, gy, w in zip(self._relu_outputs(x), self._relu_outputs(y), self.lins):
            nx = gx * torch.rsqrt(torch.sum(gx * gx, 1, keepdim=True) + 1e-10)
            ny = gy * torch.rsqrt(torch.sum(gy * gy, 1, keepdim=True) + 1e-10)
            d2 = torch.square(nx - ny)
            total = total + torch.mean(torch.sum(d2 * w.reshape(1, -1, 1, 1), 1), (1, 2))
        return total


def lpips_params_from_torch(alexnet_state: Mapping[str, torch.Tensor],
                            lin_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision ``alexnet`` state dict (``features.N.weight/bias``) plus
    the LPIPS heads (``lin{i}.model.1.weight``, ``[1, C, 1, 1]``) -> the
    state dict of :class:`LPIPS`."""
    state = {}
    for idx, *_ in _ALEX_CONVS:
        for part in ("weight", "bias"):
            state[f"features.{idx}.{part}"] = torch.as_tensor(
                alexnet_state[f"features.{idx}.{part}"], dtype=torch.float32)
    for i in range(len(_ALEX_CONVS)):
        state[f"lins.{i}"] = torch.as_tensor(lin_state[f"lin{i}.model.1.weight"],
                                             dtype=torch.float32).reshape(-1)
    return state


def lpips_model(alexnet_state, lin_state, device="cuda") -> LPIPS:
    """:class:`LPIPS` with the given weights, on ``device``, in eval mode."""
    model = LPIPS()
    model.load_state_dict(lpips_params_from_torch(alexnet_state, lin_state), strict=True)
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def video_lpips(model: LPIPS, frames_a, frames_b) -> float:
    """Mean LPIPS over corresponding frames (``[F, H, W, 3]`` uint8 or in
    [0, 1]), on the model's device."""
    dev = model.shift.device
    a = torch.as_tensor(np.asarray(frames_a, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(frames_b, np.float32), device=dev)
    if a.max() > 1.5:
        a, b = a / 255.0, b / 255.0
    return float(torch.mean(model(a * 2.0 - 1.0, b * 2.0 - 1.0)))
