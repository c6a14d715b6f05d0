"""Seeded fp32 weights, drawn on the device in one call a model.

The weight set is the reference model's (``reference.models.build``), so
the state dict loads into the reference and, with the same HF keys, into
the measured program.  Each model's parameters are one normal draw of all
its elements from a generator on the device, then scaled in place a leaf:
matrices and convolution kernels N(0, 1 / fan_in), embeddings N(0, 0.02^2),
norm scales 1 + N(0, 0.02^2), every other vector N(0, 0.02^2).  The same
seed gives the same tensors on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import models as ref_models

_STREAMS = ("unet", "gesturenet", "vae", "image_encoder", "text_encoder")


def derived_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one stream of draws of a run seeded with ``seed``
    (any non-negative whole number)."""
    lo, hi = np.random.SeedSequence([int(seed) % 2 ** 64] + [int(s) for s in stream]) \
        .generate_state(2, np.uint32).tolist()
    return (lo | hi << 32) >> 1


def reference_skeleton(name: str, sizes: dict, remat: bool = False):
    with torch.device("meta"):
        return ref_models.build(name, sizes, remat)


@torch.no_grad()
def draw(name: str, sizes: dict, seed: int, device) -> tuple:
    """(``{key: fp32 tensor}`` views of one flat buffer, the buffer)."""
    skeleton = reference_skeleton(name, sizes)
    leaves = []
    for mod_name, module in skeleton.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            key = f"{mod_name}.{pname}" if mod_name else pname
            if ref_models.is_norm(module):
                kind = "scale" if pname == "weight" else "small"
            elif isinstance(module, torch.nn.Embedding):
                kind = "small"
            elif p.dim() >= 2:
                kind = "fan_in"
            else:
                kind = "small"
            leaves.append((key, tuple(p.shape), kind))
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _STREAMS.index(name)))
    buf = torch.empty(total, device=device).normal_(generator=gen)
    out, at = {}, 0
    for key, shape, kind in leaves:
        n = math.prod(shape)
        view = buf[at:at + n].view(shape)
        at += n
        if kind == "fan_in":
            view.mul_(1.0 / math.sqrt(n // shape[0]))
        else:
            view.mul_(0.02)
            if kind == "scale":
                view.add_(1.0)
        out[key] = view
    return out, buf


def reference_model(name: str, sizes: dict, seed: int, device, remat: bool = False):
    """The reference model ``name`` holding the seeded weights (fp32)."""
    state, _ = draw(name, sizes, seed, device)
    model = reference_skeleton(name, sizes, remat)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)
