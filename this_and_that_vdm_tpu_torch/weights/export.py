"""Write a port module as an HF-layout safetensors file (counterpart of
``save_hf_layout`` / ``save_clip_hf_layout`` in
``this_and_that_vdm_tpu/weights/export.py``).

The port's ``state_dict()`` keys are already the HF names, so the file is
what diffusers' ``save_pretrained`` (UNet, GestureNet, VAE) or transformers'
(the CLIP towers) would write, and what ``weights/loader.py`` reads.
"""

from __future__ import annotations

import os

import torch

from ..models.clip import CLIPTextModel, CLIPVisionModelWithProjection
from .safetensors_io import save_file


def save_hf_layout(module: torch.nn.Module, out_dir: str, subfolder: str,
                   variant: str = "") -> str:
    """Write ``<out_dir>/<subfolder>/diffusion_pytorch_model[.variant].safetensors``
    (``model[.variant].safetensors`` for a CLIP tower).  ``variant="fp16"``
    stores every floating tensor in half precision, as the published repos
    do.  A trainable model resting split over fsdp (``parallel.ShardedParams``)
    is written inside ``TrainState.whole_params()``; outside it, it raises."""
    if any(p.untyped_storage().nbytes() == 0 and p.numel() for p in module.parameters()):
        raise ValueError("save_hf_layout: the module's parameters rest split over fsdp; "
                         "write it inside TrainState.whole_params()")
    clip = isinstance(module, (CLIPTextModel, CLIPVisionModelWithProjection))
    stem = ("model" if clip else "diffusion_pytorch_model") + (f".{variant}" if variant else "")
    d = os.path.join(out_dir, subfolder)
    os.makedirs(d, exist_ok=True)
    state = module.state_dict()
    if variant == "fp16":
        state = {k: (v.to(torch.float16) if v.is_floating_point() else v)
                 for k, v in state.items()}
    return save_file(state, os.path.join(d, stem + ".safetensors"))
