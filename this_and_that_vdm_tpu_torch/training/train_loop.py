"""End-to-end training entry point for VL (UNet) and VGL (GestureNet).

Counterpart of ``this_and_that_vdm_tpu/training/train_loop.py``: YAML config
in; the models from an HF-layout weight folder (``--pretrained``) or with
seeded random weights at the config's widths; the Bridge datasets of
``data/bridge.py`` (or ``--synthetic N`` random clips) through the threaded
``PrefetchLoader``; the train step of ``trainer.py``; checkpoints with
rotation and ``resume_from_checkpoint: latest``; JSONL/TensorBoard metrics;
validation renders every ``validation_step`` (``training/validation.py``);
an abort after 3 consecutive non-finite loss reads.  Every step prints the
host seconds the loop waited for its batch.

Several cards: one process (rank) per card over ``torch.distributed``
(``parallel/mesh.py``), on a (dcn, dp, fsdp) mesh of the ranks.  A rank
joins the process group when the launcher's environment says so
(``torchrun``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``; rank r trains on ``cuda:LOCAL_RANK``), or with
``--multihost`` / ``TTV_MULTIHOST=1``; ``--devices N`` starts N local ranks
itself (this process is rank 0, ranks 1..N-1 are child processes; with
``--device cpu`` they are gloo processes).  Each rank loads its stride of
the batches (``train_batch_size`` clips a rank); the global batch is
``train_batch_size x world``.  The trainable model rests split over
``--fsdp`` (ZeRO-3, ``parallel.shard_module``).  Rank 0 alone logs, prints
and writes; the checkpoint is collective and its file is the one-rank file.
``frozen_sharding: fsdp`` splits the frozen towers over fsdp with FSDP2.  At
the end every rank's resident trainable bytes, peak device memory and step
seconds go to ``<output_dir>/ranks.json``.

Usage:
    python -m this_and_that_vdm_tpu_torch.training.train_loop \
        --config config/train_image2video_gesturenet.yaml --mode vgl \
        [--pretrained WEIGHTS] [--synthetic N] [--max-steps N] \
        [--device cuda|cpu] [--tiny | --nano] \
        [--devices N] [--fsdp N] [--dcn N] [--multihost]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
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


def _validate(args, cfg, dcfg, models, tokenize, output_dir, step, write=True):
    """Render the instances of ``validation_img_folder`` from the live
    models (the reference's ``log_validation``); ``write``: this rank writes
    the files (rank 0)."""
    from ..pipelines import StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline
    from . import validation

    # unbaked: the weights change between renders, and under --fsdp the
    # ZeRO-3 units free their storage at rest (a graph would bake addresses)
    kw = dict(unet=models["unet"], vae=models["vae"], image_encoder=models["image_encoder"],
              text_encoder=models["text_encoder"], bake_params=False)
    pipe = (StableVideoDiffusionPipeline(**kw) if args.mode == "vl"
            else StableVideoDiffusionControlNetPipeline(controlnet=models["controlnet"], **kw))
    tokenize = tokenize or (lambda s: np.zeros((77,), np.int64))
    t0 = time.perf_counter()
    out = validation.render_validation(
        step, os.path.join(output_dir, cfg.get("validation_store_folder", "validation_results")),
        pipe, cfg["validation_img_folder"], lambda s: np.asarray(tokenize(s)).reshape(1, -1),
        mode=args.mode, num_frames=dcfg.video_seq_length, height=dcfg.height,
        width=dcfg.width, num_inference_steps=int(cfg.get("num_inference_steps", 25)),
        motion_bucket_id=_motion_or_default(cfg), write=write)
    if write:
        print(f"step {step}: rendered {len(out)} validation instances in "
              f"{time.perf_counter() - t0:.3f} s")


def _parser() -> argparse.ArgumentParser:
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
    p.add_argument("--fsdp", type=int, default=1,
                   help="ranks the trainable state is split over (innermost mesh axis)")
    p.add_argument("--dcn", type=int, default=0,
                   help="outer data axis across hosts; 0 = auto (the launcher's hosts, "
                        "WORLD_SIZE / LOCAL_WORLD_SIZE)")
    p.add_argument("--multihost", action="store_true",
                   help="join the launcher's process group (also when WORLD_SIZE is set, "
                        "or TTV_MULTIHOST=1)")
    p.add_argument("--devices", type=int, default=None,
                   help="start N local ranks (rank r on cuda:r, or gloo processes with "
                        "--device cpu); this process is rank 0")
    return p


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE")


def _start_local_ranks(argv: list, n: int):
    """Ranks 1..n-1 as child processes of this module with ``argv``, and
    the launcher environment of rank 0 set in this process.  -> (children,
    the environment entries to restore)."""
    saved = {k: os.environ.get(k) for k in _RANK_ENV}
    common = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
                  LOCAL_WORLD_SIZE=str(n))
    root = str(Path(__file__).resolve().parents[2])
    children = []
    for r in range(1, n):
        env = dict(os.environ, **common, RANK=str(r), LOCAL_RANK=str(r))
        env["PYTHONPATH"] = os.pathsep.join([root] + [x for x in [env.get("PYTHONPATH")] if x])
        children.append(subprocess.Popen(
            [sys.executable, "-m", "this_and_that_vdm_tpu_torch.training.train_loop"] + argv,
            env=env))
    os.environ.update(common, RANK="0", LOCAL_RANK="0")
    return children, saved


def _stop_local_ranks(children, saved, failed: bool, timeout: float = 600.0):
    """Wait for the child ranks (kill them when rank 0 failed: they would
    wait in a collective), restore the environment; raise on a failed child."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    bad = []
    for c in children:
        if failed:
            c.kill()
        try:
            rc = c.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            c.kill()
            rc = c.wait()
        if rc and not failed:
            bad.append(rc)
    if bad:
        raise RuntimeError(f"train_loop: {len(bad)} child rank(s) failed (exit codes {bad})")


def main(argv: Optional[list] = None, on_step: Optional[Callable] = None):
    """Train; returns the final ``TrainState``.  ``on_step(step, state,
    metrics, models)`` is called once before the first step (step 0, metrics
    None) and after every step (metrics with the host seconds the loop
    waited for the batch as ``data_wait_s``), for callers that inspect the
    run; ``models`` holds the unet, controlnet (None in VL), vae,
    image_encoder and text_encoder.  With ``--devices N`` this process is
    rank 0 (``on_step`` sees rank 0's state); on a mesh the parameters rest
    split over fsdp, whole in ``state.whole_params()``, a collective that
    ``on_step`` on one rank cannot enter: there it reads ``state.rows``
    (this rank's rows of them) or, at ``--fsdp 1``, the parameters."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: no CUDA device; pass --device cpu to train on the CPU")
    if not args.devices or "WORLD_SIZE" in os.environ:
        return _train(args, device, on_step)
    children, saved = _start_local_ranks(argv, args.devices)
    failed = True
    try:
        state = _train(args, device, on_step)
        failed = False
    finally:
        _stop_local_ranks(children, saved, failed)
    return state


def _train(args, device: torch.device, on_step: Optional[Callable]):
    if args.multihost:
        os.environ.setdefault("TTV_MULTIHOST", "1")
    ours = not dist.is_initialized()  # a caller's process group stays up
    joined = parallel.distributed_init(device_type=device.type)
    try:
        return _train_ranked(args, device, on_step, joined)
    finally:
        if joined and ours:
            dist.destroy_process_group()


def _train_ranked(args, device: torch.device, on_step: Optional[Callable], joined: bool):
    if joined and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    is_main = parallel.is_main_process()
    say = print if is_main else (lambda *a, **k: None)
    world = dist.get_world_size() if joined else 1
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world)) if joined else 1
    mesh = parallel.make_mesh(fsdp=args.fsdp, dcn=args.dcn or hosts)

    cfg = load_config(args.config)
    tcfg = train_config_from_yaml(cfg, args.mode)
    dcfg = data_config_from_yaml(cfg)
    output_dir = cfg.get("output_dir", "checkpoints/run")
    os.makedirs(output_dir, exist_ok=True)
    seed = int(cfg.get("seed", 42))
    batch_size = int(cfg.get("train_batch_size", 1))  # a rank's
    num_iters = args.max_steps or int(cfg.get("num_train_iters", 100_000))
    scale = "nano" if args.nano else "tiny" if args.tiny else "full"
    frozen_sharding = str(cfg.get("frozen_sharding", "replicated"))
    if frozen_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"frozen_sharding: {frozen_sharding!r} is not replicated or fsdp")

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
    parallel.replicate({k: p.detach() for k, p in model.named_parameters()}, mesh)
    if frozen_sharding == "fsdp":
        # the frozen towers split over fsdp (the VGL UNet with them); the
        # trainable model is split by init_train_state
        parallel.shard_frozen(modules["vae"], mesh, methods=("encode_mode", "decode"))
        parallel.shard_frozen(modules["image_encoder"], mesh)
        parallel.shard_frozen(modules["text_encoder"], mesh)
        if args.mode == "vgl":
            parallel.shard_frozen(unet, mesh)
    tx = trainer.make_optimizer(tcfg, dict(model.named_parameters()), group=mesh.group("fsdp"))
    state = trainer.init_train_state(model, tx, mesh)
    if args.mode == "vl":
        step_fn = trainer.make_vl_train_step(unet, modules, tx, tcfg, mesh=mesh)
    else:
        step_fn = trainer.make_vgl_train_step(unet, controlnet, modules, tx, tcfg, mesh=mesh)

    if cfg.get("resume_from_checkpoint") == "latest":
        latest = ckpt.latest_checkpoint(output_dir)
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            say(f"resumed from {latest} at step {state.step}")

    tokenize = None
    if args.synthetic:
        dataset = SyntheticDataset(dcfg, args.synthetic, gesture=args.mode == "vgl")
    else:
        tokenize = _tokenizer(cfg)
        ds_cls = bridge.VideoThisThatDataset if args.mode == "vgl" else bridge.VideoDataset
        dataset = ds_cls(dcfg, tokenize, seed=seed)
    if len(dataset) < batch_size * world:
        raise ValueError(f"{len(dataset)} instances make no global batch of "
                         f"{batch_size} x {world} ranks")
    loader = bridge.PrefetchLoader(dataset, batch_size,
                                   num_workers=int(cfg.get("dataloader_num_workers", 4)),
                                   seed=seed, shard=(mesh.index(), mesh.size))
    logger = MetricLogger(os.path.join(output_dir, cfg.get("logging_name", "logging"))) \
        if is_main else None
    ckpt_every = int(cfg.get("checkpointing_steps", 3000))
    total_limit = int(cfg.get("checkpoints_total_limit", 15))
    val_every = int(cfg.get("validation_step", 0) or 0)

    models = dict(unet=unet, controlnet=controlnet, **modules)
    if on_step is not None:
        on_step(state.step, state, None, models)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the steps' peak, for ranks.json
    nonfinite_reads = 0
    t0 = time.perf_counter()
    step_s = []
    say(f"training {args.mode} on {device}, mesh {mesh.shape}, global batch "
        f"{batch_size * world} ({batch_size}/rank), "
        f"{sum(p.numel() for p in state.params.values()) / 1e6:.1f} M trainable parameters")
    while state.step < num_iters:
        t_ask = time.perf_counter()
        for batch in loader:
            wait = time.perf_counter() - t_ask
            if state.step >= num_iters:
                break
            batch = parallel.global_batch(batch, mesh, device)
            t_step = time.perf_counter()
            state, m = step_fn(state, batch, gen)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t_step)
            m["data_wait_s"] = wait
            step = state.step
            line = f"step {step}: waited {wait:.4f} s for the batch"
            if step % 10 == 0 or step == 1:
                # the loss is the global batch's on every rank: every rank
                # takes the same branch below
                loss = float(m["loss"])
                if logger is not None:
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
            say(line)
            if on_step is not None:
                on_step(step, state, m, models)
            if step % ckpt_every == 0:
                path = ckpt.save_checkpoint(output_dir, step, state, total_limit)
                say(f"step {step}: saved {path} ({time.perf_counter() - t0:.1f}s elapsed)")
            if val_every and cfg.get("validation_img_folder") and step % val_every == 0:
                # every rank gathers the trainable model whole, then rank 0
                # renders; towers split over fsdp gather their blocks
                # collectively, so then every rank renders in step and rank
                # 0 writes
                with state.whole_params():
                    if is_main or frozen_sharding == "fsdp":
                        _validate(args, cfg, dcfg, models, tokenize, output_dir, step,
                                  write=is_main)
                    if joined:
                        dist.barrier()
            t_ask = time.perf_counter()
    path = ckpt.save_checkpoint(output_dir, state.step, state, total_limit)
    say(f"done at step {state.step}; final checkpoint {path}")
    _rank_report(state, device, joined, step_s, output_dir, say)
    if logger is not None:
        logger.close()
    return state


def _rank_report(state, device, joined: bool, step_s: list, output_dir: str, say):
    """Each rank's trainable parameter bytes at rest, its peak device memory
    and its step seconds (a step ends in a device sync): printed by rank 0
    and written to ``<output_dir>/ranks.json`` (collective on a mesh)."""
    resident = (state.rows.resident_bytes() if state.rows is not None else
                sum(p.numel() * p.element_size() for p in state.params.values()))
    mine = dict(rank=dist.get_rank() if joined else 0, resident_param_bytes=resident,
                whole_param_bytes=sum(p.numel() * p.element_size()
                                      for p in state.params.values()),
                leaves=len(state.params),
                peak_bytes=torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None, step_s=step_s)
    ranks = [mine]
    if joined:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
    if parallel.is_main_process():
        with open(os.path.join(output_dir, "ranks.json"), "w") as f:
            json.dump(ranks, f)
        for r in ranks:
            peak = "n/a" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.2f} GiB"
            say(f"rank {r['rank']}: trainable parameters at rest "
                f"{r['resident_param_bytes'] / 2**30:.3f} of {r['whole_param_bytes'] / 2**30:.3f}"
                f" GiB, peak {peak}, seconds per step {[round(t, 4) for t in r['step_s']]}")


if __name__ == "__main__":
    main()
