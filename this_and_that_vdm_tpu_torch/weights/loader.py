"""Load HF-layout pretrained weight folders into the port's modules
(counterpart of ``this_and_that_vdm_tpu/weights/loader.py``).

The weight contract of the published checkpoints (HF
``HikariDawn/This-and-That-1.{0,1}`` and the SVD base repo)::

    <root>/unet/diffusion_pytorch_model[.fp16].safetensors        (VL UNet)
    <root>/gesturenet/diffusion_pytorch_model[.fp16].safetensors  (GestureNet)
    <root>/vae/...                                                (temporal VAE)
    <root>/image_encoder/model[.fp16].safetensors                 (CLIP ViT-H)
    <root>/text_encoder/model[.fp16].safetensors                  (CLIP text)

The port's modules carry the HF key names, so a state dict loads with
``load_state_dict(strict=True)`` and no converter.  Modules are built on the
meta device and take the loaded tensors as they are (``assign=True``), then
go to ``device`` with their matmul / conv weights in ``dtype``
(``cast_compute_dtype``; norms stay fp32).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import torch

from ..models import cast_compute_dtype, init_weights
from ..models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                           CLIPVisionModelWithProjection)
from ..models.controlnet import ControlNetConfig, ControlNetModel
from ..models.unet import UNetConfig, UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder, VAEConfig
from ..pipelines import StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline
from .safetensors_io import load_file

_CLASSES = dict(unet=UNetSpatioTemporalConditionModel, gesturenet=ControlNetModel,
                vae=AutoencoderKLTemporalDecoder, image_encoder=CLIPVisionModelWithProjection,
                text_encoder=CLIPTextModel)


def model_configs(scale: str = "full") -> dict:
    """The five models' configs: ``full`` = the published widths, ``tiny`` =
    the JAX CLI's tiny set (``--random-weights`` and the weights rehearsal),
    ``nano`` = the tiny set with the 2-block nano UNet and GestureNet (the
    fastest training smoke)."""
    if scale == "full":
        return dict(unet=UNetConfig(), gesturenet=ControlNetConfig(), vae=VAEConfig(),
                    image_encoder=CLIPVisionConfig(), text_encoder=CLIPTextConfig())
    if scale not in ("tiny", "nano"):
        raise ValueError(f"unknown model scale {scale!r}")
    ucfg = getattr(UNetConfig, scale)()
    ctx = ucfg.cross_attention_dim
    return dict(unet=ucfg, gesturenet=getattr(ControlNetConfig, scale)(), vae=VAEConfig.tiny(),
                image_encoder=CLIPVisionConfig(hidden_size=32, num_layers=1, num_heads=4,
                                               intermediate_size=64, patch_size=56,
                                               image_size=224, projection_dim=ctx),
                text_encoder=CLIPTextConfig(vocab_size=49408, hidden_size=ctx, num_layers=1,
                                            num_heads=4, intermediate_size=64,
                                            max_positions=77))


def build_module(name: str, scale: str = "full", device="cuda"):
    """An uninitialised model (``name`` a key of ``model_configs``) on ``device``."""
    with torch.device(device):
        return _CLASSES[name](model_configs(scale)[name])


def random_models(scale: str = "full", device="cuda", seed: int = 0) -> dict:
    """The five models with seeded random weights (``init_weights``, one
    generator on ``device`` drawn in ``model_configs`` order), fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: init_weights(build_module(name, scale, device), gen).eval().requires_grad_(False)
            for name in model_configs(scale)}


def make_pipeline(models: dict, mode: str = "vgl"):
    """The VGL (``mode="vgl"``: with the GestureNet) or VL pipeline over a
    dict of the five models (``gesturenet`` unused in VL)."""
    kw = dict(unet=models["unet"], vae=models["vae"], image_encoder=models["image_encoder"],
              text_encoder=models["text_encoder"])
    if mode == "vgl":
        return StableVideoDiffusionControlNetPipeline(controlnet=models["gesturenet"], **kw)
    if mode != "vl":
        raise ValueError(f"unknown mode {mode!r}")
    return StableVideoDiffusionPipeline(**kw)


def _load_dir(path: str) -> Dict[str, torch.Tensor]:
    # recursive: shards nested more than one level deep must not be missed
    files = sorted(glob.glob(os.path.join(path, "**", "*.safetensors"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    state = {}
    for f in files:
        state.update(load_file(f))
    # fp16 is a storage format (the published repos ship variant="fp16"):
    # parameters are fp32 until cast to the compute dtype
    return {k: (v.float() if v.dtype == torch.float16 else v) for k, v in state.items()}


def _build(name: str, state: Dict[str, torch.Tensor], config, device, dtype):
    """The ``name`` model of ``config`` holding ``state`` (strict), its
    matmul / conv weights cast to ``dtype`` (None: as loaded), on ``device``."""
    if name in ("image_encoder", "text_encoder"):
        # some transformers checkpoints carry the position_ids buffer
        state = {k: v for k, v in state.items() if not k.endswith("position_ids")}
    with torch.device("meta"):
        module = _CLASSES[name](config)
    module.load_state_dict(state, strict=True, assign=True)
    if dtype is not None:
        cast_compute_dtype(module, dtype)
    return module.to(device).eval().requires_grad_(False)


def load_unet(root: str, subfolder: str = "unet", scale: str = "full", device="cuda",
              dtype: Optional[torch.dtype] = None):
    return _build("unet", _load_dir(os.path.join(root, subfolder)),
                  model_configs(scale)["unet"], device, dtype)


def load_gesturenet(root: str, subfolder: str = "gesturenet", scale: str = "full",
                    device="cuda", dtype: Optional[torch.dtype] = None):
    return _build("gesturenet", _load_dir(os.path.join(root, subfolder)),
                  model_configs(scale)["gesturenet"], device, dtype)


def load_vae(root: str, subfolder: str = "vae", scale: str = "full", device="cuda",
             dtype: Optional[torch.dtype] = None):
    return _build("vae", _load_dir(os.path.join(root, subfolder)),
                  model_configs(scale)["vae"], device, dtype)


def load_clip(root: str, subfolder: str, scale: str = "full", device="cuda",
              dtype: Optional[torch.dtype] = None):
    """The CLIP text or vision tower in ``<root>/<subfolder>``, told apart by
    its keys (``vision_model.*`` or ``text_model.*``)."""
    state = _load_dir(os.path.join(root, subfolder))
    name = ("image_encoder" if any(k.startswith("vision_model.") for k in state)
            else "text_encoder")
    return _build(name, state, model_configs(scale)[name], device, dtype)


def load_pretrained(root: str, mode: str = "vgl", device="cuda",
                    dtype: Optional[torch.dtype] = torch.bfloat16, scale: str = "full"):
    """The VGL (``mode="vgl"``) or VL pipeline over the weights under ``root``."""
    kw = dict(scale=scale, device=device, dtype=dtype)
    models = dict(unet=load_unet(root, **kw), vae=load_vae(root, **kw),
                  image_encoder=load_clip(root, "image_encoder", **kw),
                  text_encoder=load_clip(root, "text_encoder", **kw))
    if mode == "vgl":
        models["gesturenet"] = load_gesturenet(root, **kw)
    return make_pipeline(models, mode)


def load_training_models(root: str, mode: str = "vgl", configs: Optional[dict] = None,
                         device="cuda", frozen_dtype: torch.dtype = torch.float32):
    """``(unet, controlnet or None, {vae, image_encoder, text_encoder})`` for
    training, from the weights under ``root`` (the contract of the JAX
    ``load_pretrained`` in training): the trainable model (the UNet in
    ``vl``, the GestureNet in ``vgl``) in fp32 with ``requires_grad`` on, in
    train mode; the frozen towers (and the VGL UNet) in ``frozen_dtype``,
    ``requires_grad`` off.  ``configs`` (name -> config, default
    ``model_configs("full")``) sets the widths and ``remat``.  VGL needs
    ``<root>/gesturenet/``: no GestureNet is made from the UNet."""
    if mode not in ("vl", "vgl"):
        raise ValueError(f"unknown mode {mode!r}")
    configs = configs or model_configs("full")
    names = ["vae", "image_encoder", "text_encoder", "unet"] + (["gesturenet"] * (mode == "vgl"))
    trainable = "unet" if mode == "vl" else "gesturenet"
    models = {}
    for name in names:
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            raise FileNotFoundError(f"{sub}: no such weight folder (--mode {mode} trains from "
                                    f"{', '.join(n + '/' for n in names)} under the tree)")
        state = _load_dir(sub)
        if name == trainable:
            model = _build(name, state, configs[name], device, None).float()
            models[name] = model.train().requires_grad_(True)
        else:
            models[name] = _build(name, state, configs[name], device, frozen_dtype)
    modules = {k: models[k] for k in ("vae", "image_encoder", "text_encoder")}
    return models["unet"], models.get("gesturenet"), modules
