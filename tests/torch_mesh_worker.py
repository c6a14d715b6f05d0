"""One rank of the port's multi-process train-step checks (gloo on the CPU).

    python tests/torch_mesh_worker.py RANK WORLD PORT DIR

``DIR`` holds ``models.pt`` (the state dicts of the nano towers, UNet and
GestureNet), ``data.npz`` (two global batches and the draws of each step)
and ``scenarios.json``; each scenario ``[mode, fsdp, frozen, optim]`` trains
two steps on the (dp, fsdp) mesh of the WORLD ranks and rank 0 writes
``DIR/<name>.npz`` (losses, gradient norms, the parameters after the last
step, and each rank's bytes of trainable parameter storage between steps
beside the whole model's bytes and its leaf count).  ``optim`` ``"pf_acc"``
trains with ``partial_finetune`` and two accumulated steps
(``multi_transform`` and ``multi_steps`` over the rank's rows).  The fsdp 2
runs train under ``remat`` (the recompute gathers its units again).  The
``vgl`` fsdp 2 runs with replicated towers also write their collective
checkpoint after step 1 to ``DIR/<name>_ckpt``, and the ``adam8bit`` one
renders the validation instance ``DIR/val`` after its last step, rank 0
alone inside the collective whole-parameters context as ``train_loop``
does, to ``DIR/<name>_render``.

Imports the port only (no jax, no tests/conftest.py); the test process runs
:func:`run_steps` itself for the one-process reference.
"""

import json
import os
import sys

import numpy as np
import torch

from this_and_that_vdm_tpu_torch import parallel
from this_and_that_vdm_tpu_torch.models import clip, controlnet, unet, vae
from this_and_that_vdm_tpu_torch.training import checkpoint as ckpt
from this_and_that_vdm_tpu_torch.training import trainer

CTX = 48
LR = 1e-5
VIS = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, patch_size=56,
           image_size=224, projection_dim=CTX)
TXT = dict(vocab_size=64, hidden_size=CTX, num_layers=1, num_heads=4, intermediate_size=64,
           max_positions=16)
STEPS = 2
OPTIM = {"adam8bit": {}, "pf_acc": dict(partial_finetune=True, gradient_accumulation_steps=2)}


def scenario_name(mode, fsdp, frozen, optim):
    return f"{mode}_fsdp{fsdp}_{frozen}_{optim}"


def build(states: dict, mode: str, remat: bool = False):
    """(trainable model, unet, frozen towers) from the saved state dicts;
    ``remat``: the UNet and GestureNet checkpoint their blocks."""
    towers = dict(vae=vae.AutoencoderKLTemporalDecoder(vae.VAEConfig.tiny()),
                  image_encoder=clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(**VIS)),
                  text_encoder=clip.CLIPTextModel(clip.CLIPTextConfig(**TXT)))
    for k, m in towers.items():
        m.load_state_dict(states[k])
        m.requires_grad_(False)
    u = unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.nano(remat))
    u.load_state_dict(states["unet"])
    if mode == "vl":
        return u.train(), u, towers
    u.requires_grad_(False)
    cn = controlnet.ControlNetModel(controlnet.ControlNetConfig.nano(remat))
    cn.load_state_dict(states["controlnet"])
    return cn.train(), u, towers


def make_step(mode, model, u, towers, mesh, optim="adam8bit"):
    cfg = trainer.TrainConfig(learning_rate=LR, lr_warmup_steps=0, use_8bit_adam=True,
                              max_grad_norm=1.0 if mode == "vgl" else None, **OPTIM[optim])
    group = None if mesh is None else mesh.group("fsdp")
    tx = trainer.make_optimizer(cfg, dict(model.named_parameters()), group=group)
    state = trainer.init_train_state(model, tx, mesh)
    if mode == "vl":
        return state, trainer.make_vl_train_step(u, towers, tx, cfg, mesh=mesh)
    return state, trainer.make_vgl_train_step(u, model, towers, tx, cfg, mesh=mesh)


def batch_and_draws(data, i: int, mode: str):
    keys = ("video_frames", "prompt_ids", "motion_bucket_id") + (("condition",)
                                                                  if mode == "vgl" else ())
    batch = {k: data[f"batch{i}_{k}"] for k in keys}
    draws = {k: data[f"draws{i}_{k}"] for k in ("sigma", "noise", "aug", "dropout")}
    return batch, draws


def run_steps(states, data, mode, mesh=None, frozen="replicated", ckpt_dir=None,
              resume=None, first=0, optim="adam8bit", remat=False, render=None):
    """Steps ``first``..STEPS-1 of ``mode`` on ``mesh`` (None: one process,
    the global batch), from the checkpoint ``resume`` if given; ``render``:
    ``(instances dir, output dir)`` of a validation render after the last
    step (the dir's ``shape.json``: frames, height, width) -> (losses, grad
    norms, final params, state, trainable parameter bytes at rest after the
    last step)."""
    model, u, towers = build(states, mode, remat)
    if frozen == "fsdp":
        parallel.shard_frozen(towers["vae"], mesh, methods=("encode_mode", "decode"))
        parallel.shard_frozen(towers["image_encoder"], mesh)
        parallel.shard_frozen(towers["text_encoder"], mesh)
        if mode == "vgl":
            parallel.shard_frozen(u, mesh)
    state, step = make_step(mode, model, u, towers, mesh, optim)
    if resume is not None:
        state = ckpt.restore_checkpoint(resume, state)
    losses, norms = [], []
    for i in range(first, STEPS):
        batch, draws = batch_and_draws(data, i, mode)
        if mesh is not None:
            batch = parallel.shard_batch(batch, mesh)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        state, m = step(state, batch, draws=draws)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if ckpt_dir is not None and i == 0:
            ckpt.save_checkpoint(ckpt_dir, state.step, state)
    assert all(p.grad is None for p in state.params.values())
    resident = (state.rows.resident_bytes() if state.rows is not None
                else sum(p.numel() * 4 for p in state.params.values()))
    with state.whole_params():  # collective on a mesh: the rows gathered whole
        params = {k: p.detach().numpy().copy() for k, p in state.params.items()}
        if render is not None and parallel.is_main_process():
            validate(model, u, towers, mode, *render)
        if mesh is not None:
            torch.distributed.barrier()
    return losses, norms, params, state, resident


def validate(model, u, towers, mode, instances, out):
    """The validation render of ``train_loop`` (one 1-step instance at the
    batch's size) from the live models."""
    from this_and_that_vdm_tpu_torch.pipelines import (StableVideoDiffusionControlNetPipeline,
                                                       StableVideoDiffusionPipeline)
    from this_and_that_vdm_tpu_torch.training import validation

    kw = dict(unet=u, vae=towers["vae"], image_encoder=towers["image_encoder"],
              text_encoder=towers["text_encoder"])
    pipe = (StableVideoDiffusionPipeline(**kw) if mode == "vl"
            else StableVideoDiffusionControlNetPipeline(controlnet=model, **kw))
    frames, height, width = json.load(open(os.path.join(instances, "shape.json")))
    return validation.render_validation(1, out, pipe, instances,
                                        lambda s: np.zeros((1, TXT["max_positions"]), np.int64),
                                        mode=mode, num_frames=frames, height=height, width=width,
                                        num_inference_steps=1)


def main():
    rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    assert parallel.distributed_init(device_type="cpu")
    states = torch.load(os.path.join(root, "models.pt"))
    data = dict(np.load(os.path.join(root, "data.npz")))
    with open(os.path.join(root, "scenarios.json")) as f:
        scenarios = json.load(f)
    for mode, fsdp, frozen, optim in scenarios:
        mesh = parallel.make_mesh(fsdp=fsdp)
        name = scenario_name(mode, fsdp, frozen, optim)
        save = mode == "vgl" and fsdp == 2 and frozen == "replicated"
        render = ((os.path.join(root, "val"), os.path.join(root, f"{name}_render"))
                  if save and optim == "adam8bit" else None)
        losses, norms, params, state, resident = run_steps(
            states, data, mode, mesh, frozen, os.path.join(root, f"{name}_ckpt") if save else None,
            optim=optim, remat=fsdp > 1, render=render)
        every = [None] * world
        torch.distributed.all_gather_object(every, resident)
        if parallel.is_main_process():
            np.savez(os.path.join(root, f"{name}.npz"), losses=losses, norms=norms,
                     resident=every, leaves=len(params),
                     whole=sum(v.size * v.itemsize for v in params.values()),
                     **{f"p.{k}": v for k, v in params.items()})
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MESH_WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
