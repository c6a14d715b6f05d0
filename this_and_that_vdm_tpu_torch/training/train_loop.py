"""End-to-end training entry point for VL (UNet) and VGL (GestureNet).

Counterpart of ``this_and_that_vdm_tpu/training/train_loop.py``: YAML config
in; the models from an HF-layout weight folder (``--pretrained``) or with
seeded random weights at the config's widths; the Bridge datasets of
``data/bridge.py`` (or ``--synthetic N`` random clips) through the threaded
``PrefetchLoader``; the train step of ``trainer.py`` on one device;
checkpoints with rotation and ``resume_from_checkpoint: latest``;
JSONL/TensorBoard metrics; validation renders every ``validation_step``
(``training/validation.py``); an abort after 3 consecutive non-finite loss
reads.  Every step prints the host seconds the loop waited for its batch.

Usage:
    python -m this_and_that_vdm_tpu_torch.training.train_loop \
        --config config/train_image2video_gesturenet.yaml --mode vgl \
        [--pretrained WEIGHTS] [--synthetic N] [--max-steps N] \
        [--device cuda|cpu] [--tiny | --nano]

Runs on the CUDA card unless ``--device cpu`` is given.  Not ported yet:
the multi-device flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data import bridge
from ..models import cast_compute_dtype, init_weights
from ..models.clip import CLIPTextModel, CLIPVisionModelWithProjection
from ..models.controlnet import ControlNetModel
from ..models.unet import UNetSpatioTemporalConditionModel
from ..models.vae import AutoencoderKLTemporalDecoder
from ..weights import loader as weight_loader
from . import checkpoint as ckpt
from . import trainer
from .metrics import MetricLogger


# ------------------------------------------------------------------ config

def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _motion_or_default(cfg: dict) -> int:
    """motion_bucket_id: None/absent -> 200; an explicit 0 is a valid bucket."""
    v = cfg.get("motion_bucket_id")
    return 200 if v is None else int(v)


def train_config_from_yaml(cfg: dict, mode: str) -> trainer.TrainConfig:
    return trainer.TrainConfig(
        learning_rate=float(cfg.get("learning_rate", 1e-5)),
        lr_warmup_steps=int(cfg.get("lr_warmup_steps", 500)),
        adam_beta1=float(cfg.get("adam_beta1", 0.9)),
        adam_beta2=float(cfg.get("adam_beta2", 0.999)),
        adam_weight_decay=float(cfg.get("adam_weight_decay", 1e-2)),
        adam_epsilon=float(cfg.get("adam_epsilon", 1e-8)),
        noise_mean=float(cfg.get("noise_mean", 0.5)),
        noise_std=float(cfg.get("noise_std", 1.4)),
        conditioning_dropout_prob=float(cfg.get("conditioning_dropout_prob", 0.1)),
        train_noise_aug_strength=float(cfg.get("train_noise_aug_strength", 0.1)),
        process_fps=int(cfg.get("process_fps", 7)),
        motion_bucket_id=_motion_or_default(cfg),
        max_grad_norm=1.0 if mode == "vgl" else None,
        partial_finetune=bool(cfg.get("partial_finetune", False)),
        use_text=bool(cfg.get("use_text", True)),
        gradient_accumulation_steps=int(cfg.get("gradient_accumulation_steps", 1)),
        use_8bit_adam=bool(cfg.get("use_8bit_adam", False)),
    )


def frozen_dtype_from_yaml(cfg: dict) -> torch.dtype:
    """``mixed_precision`` -> dtype of the frozen towers (the VAE, both CLIP
    towers and, in VGL, the UNet); the trainable model stays fp32.  The
    reference's fp16 maps to bf16, as in the JAX package."""
    mp = str(cfg.get("mixed_precision", "no")).lower()
    return torch.bfloat16 if mp in ("fp16", "float16", "bf16", "bfloat16") else torch.float32


def data_config_from_yaml(cfg: dict) -> bridge.DataConfig:
    return bridge.DataConfig(
        dataset_path=tuple(cfg.get("dataset_path") or ()),
        video_seq_length=int(cfg.get("video_seq_length", 14)),
        height=int(cfg.get("height", 256)),
        width=int(cfg.get("width", 384)),
        flip_aug_prob=float(cfg.get("flip_aug_prob", 0.45)),
        acceleration_tolerance=int(cfg.get("acceleration_tolerance", 4)),
        use_text=bool(cfg.get("use_text", True)),
        mix_ambiguous=bool(cfg.get("mix_ambiguous", False)),
        empty_prompts_proportion=float(cfg.get("empty_prompts_proportion", 0.0)),
        motion_bucket_id=cfg.get("motion_bucket_id", 200),
        dataset_motion_mean=float(cfg.get("dataset_motion_mean", 35.3)),
        dataset_motion_std=float(cfg.get("dataset_motion_std", 18.5)),
        svd_motion_mean=float(cfg.get("svd_motion_mean", 165)),
        svd_motion_std=float(cfg.get("svd_motion_std", 22.5)),
    )


# -------------------------------------------------------------------- data

class SyntheticDataset:
    """Random items with the dataset contract, item ``i`` seeded by ``i``."""

    def __init__(self, dcfg: bridge.DataConfig, n: int = 64, gesture: bool = False):
        self.dcfg, self.n, self.gesture = dcfg, n, gesture

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        d = self.dcfg
        item = dict(
            video_frames=rng.randn(d.video_seq_length, d.height, d.width, 3)
            .astype(np.float32).clip(-1, 1),
            prompt_ids=rng.randint(0, 1000, (77,)).astype(np.int64),
            motion_bucket_id=np.float32(200),
        )
        if self.gesture:
            item["condition"] = rng.rand(d.video_seq_length, d.height, d.width, 3) \
                .astype(np.float32)
        return item


# ------------------------------------------------------------------ models

_ZERO_INIT = ("conv_in_concat", "controlnet_down_blocks", "controlnet_mid_block")


def model_configs(cfg: dict, mode: str, scale: str = "full") -> dict:
    """``weights.loader.model_configs(scale)`` with, at full width, the
    config's ``gradient_checkpointing`` as the UNet's ``remat`` and, in VGL,
    the GestureNet's: the UNet is checkpointed in VGL too, frozen but in the
    gradient path."""
    configs = weight_loader.model_configs(scale)
    if scale == "full":
        remat = bool(cfg.get("gradient_checkpointing", 1))
        configs["unet"] = dataclasses.replace(configs["unet"], remat=remat)
        configs["gesturenet"] = dataclasses.replace(configs["gesturenet"],
                                                    remat=remat and mode == "vgl")
    return configs


def build_models(cfg: dict, mode: str, tiny: bool = False, nano: bool = False,
                 frozen_dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
    """(unet, controlnet or None, {vae, image_encoder, text_encoder}) with
    seeded random weights on ``device``: the frozen towers (and the VGL UNet)
    in ``frozen_dtype`` with ``requires_grad`` off, the trainable model in
    fp32.  The GestureNet's zero convs start at zero, as its JAX init does."""
    c = model_configs(cfg, mode, "nano" if nano else "tiny" if tiny else "full")
    gen = generator or torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        modules = dict(vae=AutoencoderKLTemporalDecoder(c["vae"]),
                       image_encoder=CLIPVisionModelWithProjection(c["image_encoder"]),
                       text_encoder=CLIPTextModel(c["text_encoder"]))
        unet = UNetSpatioTemporalConditionModel(c["unet"])
        controlnet = ControlNetModel(c["gesturenet"]) if mode == "vgl" else None
    frozen = list(modules.values()) + ([unet] if mode == "vgl" else [])
    for m in frozen:
        cast_compute_dtype(init_weights(m, gen), frozen_dtype).eval().requires_grad_(False)
    trainable = unet if mode == "vl" else controlnet
    init_weights(trainable, gen).train()
    if controlnet is not None:
        with torch.no_grad():
            for name in _ZERO_INIT:
                for p in getattr(controlnet, name).parameters():
                    p.zero_()
    return unet, controlnet, modules


# -------------------------------------------------------------------- main

def _tokenizer(cfg: dict):
    """``prompt -> [77]`` ids through the port's CLIP tokenizer, read from
    ``<pretrained_tokenizer_name_or_path>/tokenizer`` (a local folder)."""
    from ..cli.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(cfg.get("pretrained_tokenizer_name_or_path"),
                                        subfolder="tokenizer")
    return lambda s: tok([s])[0]


def _validate(args, cfg, dcfg, models, tokenize, output_dir, step):
    """Render the instances of ``validation_img_folder`` from the live
    models (the reference's ``log_validation``)."""
    from ..pipelines import StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline
    from . import validation

    kw = dict(unet=models["unet"], vae=models["vae"], image_encoder=models["image_encoder"],
              text_encoder=models["text_encoder"])
    pipe = (StableVideoDiffusionPipeline(**kw) if args.mode == "vl"
            else StableVideoDiffusionControlNetPipeline(controlnet=models["controlnet"], **kw))
    tokenize = tokenize or (lambda s: np.zeros((77,), np.int64))
    t0 = time.perf_counter()
    out = validation.render_validation(
        step, os.path.join(output_dir, cfg.get("validation_store_folder", "validation_results")),
        pipe, cfg["validation_img_folder"], lambda s: np.asarray(tokenize(s)).reshape(1, -1),
        mode=args.mode, num_frames=dcfg.video_seq_length, height=dcfg.height,
        width=dcfg.width, num_inference_steps=int(cfg.get("num_inference_steps", 25)),
        motion_bucket_id=_motion_or_default(cfg))
    print(f"step {step}: rendered {len(out)} validation instances in "
          f"{time.perf_counter() - t0:.3f} s")


def main(argv: Optional[list] = None, on_step: Optional[Callable] = None):
    """Train; returns the final ``TrainState``.  ``on_step(step, state,
    metrics, models)`` is called once before the first step (step 0, metrics
    None) and after every step (metrics with the host seconds the loop
    waited for the batch as ``data_wait_s``), for callers that inspect the
    run; ``models`` holds the unet, controlnet (None in VL), vae,
    image_encoder and text_encoder."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--mode", choices=["vl", "vgl"], default="vl")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic instances instead of dataset_path")
    p.add_argument("--tiny", action="store_true", help="tiny model configs (smoke)")
    p.add_argument("--nano", action="store_true", help="2-block nano configs (smoke)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--pretrained", default=None,
                   help="dir with HF-layout subfolders (unet/, gesturenet/, vae/, ...)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA device; pass --device cpu to train on the CPU")

    cfg = load_config(args.config)
    tcfg = train_config_from_yaml(cfg, args.mode)
    dcfg = data_config_from_yaml(cfg)
    output_dir = cfg.get("output_dir", "checkpoints/run")
    os.makedirs(output_dir, exist_ok=True)
    seed = int(cfg.get("seed", 42))
    batch_size = int(cfg.get("train_batch_size", 1))
    num_iters = args.max_steps or int(cfg.get("num_train_iters", 100_000))
    scale = "nano" if args.nano else "tiny" if args.tiny else "full"

    gen = torch.Generator(device=device).manual_seed(seed)
    fdtype = frozen_dtype_from_yaml(cfg)
    if args.pretrained:
        unet, controlnet, modules = weight_loader.load_training_models(
            args.pretrained, args.mode, model_configs(cfg, args.mode, scale), device, fdtype)
    else:
        unet, controlnet, modules = build_models(
            cfg, args.mode, tiny=args.tiny, nano=args.nano, frozen_dtype=fdtype,
            device=device, generator=gen)
    model = unet if args.mode == "vl" else controlnet
    tx = trainer.make_optimizer(tcfg, dict(model.named_parameters()))
    state = trainer.init_train_state(model, tx)
    if args.mode == "vl":
        step_fn = trainer.make_vl_train_step(unet, modules, tx, tcfg)
    else:
        step_fn = trainer.make_vgl_train_step(unet, controlnet, modules, tx, tcfg)

    if cfg.get("resume_from_checkpoint") == "latest":
        latest = ckpt.latest_checkpoint(output_dir)
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} at step {state.step}")

    tokenize = None
    if args.synthetic:
        dataset = SyntheticDataset(dcfg, args.synthetic, gesture=args.mode == "vgl")
    else:
        tokenize = _tokenizer(cfg)
        ds_cls = bridge.VideoThisThatDataset if args.mode == "vgl" else bridge.VideoDataset
        dataset = ds_cls(dcfg, tokenize, seed=seed)
    if len(dataset) < batch_size:
        raise ValueError(f"{len(dataset)} instances make no batch of {batch_size}")
    loader = bridge.PrefetchLoader(dataset, batch_size,
                                   num_workers=int(cfg.get("dataloader_num_workers", 4)),
                                   seed=seed)
    logger = MetricLogger(os.path.join(output_dir, cfg.get("logging_name", "logging")))
    ckpt_every = int(cfg.get("checkpointing_steps", 3000))
    total_limit = int(cfg.get("checkpoints_total_limit", 15))
    val_every = int(cfg.get("validation_step", 0) or 0)

    models = dict(unet=unet, controlnet=controlnet, **modules)
    if on_step is not None:
        on_step(state.step, state, None, models)
    nonfinite_reads = 0
    t0 = time.perf_counter()
    print(f"training {args.mode} on {device}, batch {batch_size}, "
          f"{sum(p.numel() for p in state.params.values()) / 1e6:.1f} M trainable parameters")
    while state.step < num_iters:
        t_ask = time.perf_counter()
        for batch in loader:
            wait = time.perf_counter() - t_ask
            if state.step >= num_iters:
                break
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            state, m = step_fn(state, batch, gen)
            m["data_wait_s"] = wait
            step = state.step
            line = f"step {step}: waited {wait:.4f} s for the batch"
            if step % 10 == 0 or step == 1:
                loss = float(m["loss"])
                logger.log(step, loss=loss, grad_norm=float(m["grad_norm"]))
                line += f", loss {loss:.6f}"
                # a diverged run burns accelerator hours silently: abort once
                # the loss stays non-finite
                if not math.isfinite(loss):
                    nonfinite_reads += 1
                    if nonfinite_reads >= 3:
                        raise RuntimeError(
                            f"loss non-finite for {nonfinite_reads} consecutive reads "
                            f"(step {step}); aborting. Resume from the last checkpoint "
                            f"with a lower learning rate or grad clip.")
                else:
                    nonfinite_reads = 0
            print(line)
            if on_step is not None:
                on_step(step, state, m, models)
            if step % ckpt_every == 0:
                path = ckpt.save_checkpoint(output_dir, step, state, total_limit)
                print(f"step {step}: saved {path} ({time.perf_counter() - t0:.1f}s elapsed)")
            if val_every and cfg.get("validation_img_folder") and step % val_every == 0:
                _validate(args, cfg, dcfg, models, tokenize, output_dir, step)
            t_ask = time.perf_counter()
    path = ckpt.save_checkpoint(output_dir, state.step, state, total_limit)
    print(f"done at step {state.step}; final checkpoint {path}")
    logger.close()
    return state


if __name__ == "__main__":
    main()
