"""EDM finetuning steps for VL (UNet) and VGL (GestureNet over a frozen UNet).

Counterpart of ``this_and_that_vdm_tpu/training/trainer.py``: one step holds
the whole reference step (train_code/train_svd.py, train_csvd.py) — frozen
VAE + CLIP encodes under ``torch.no_grad()``, EDM noising, conditioning
dropout, the model forward, the weighted reconstruction loss, the
gradients and the optimizer update.

Reference knobs: constant-with-warmup LR, AdamW (betas 0.9/0.999, eps 1e-8,
wd 1e-2), ``partial_finetune`` (only parameters whose name mentions
attention or embeddings), per-block gradient checkpointing (the models'
``remat``), VGL grad-norm clip 1.0, conditioning dropout 0.1, and the VGL
sparse-conditioning ``mask_*`` knobs.  The schedule is read before its count
increments (optax ``scale_by_schedule``): with a warmup the first update
uses lr = 0 and moves no parameter, weight decay included.

Random draws come from a ``torch.Generator``; a step also takes them
explicitly (``draws``): ``sigma`` N(0,1) ``[B]``, ``noise`` N(0,1) like the
latents, ``aug`` N(0,1) like the first frame, ``dropout`` U(0,1) ``[B]``,
``mask`` U(0,1) ``[B, F, h, w, 1]``.

On a mesh of ranks (``mesh=``, under a process group) each rank takes its
rows of the global batch: every draw is made at the global batch's shape
from the shared generator (or injected at that shape) and the rank keeps
its rows, so the split does not change the numbers.  The trainable state
is split over fsdp (ZeRO-3, ``parallel.shard_module``): the backward
reduce-scatters each unit's gradients into the rank's rows as they
complete, the rows are all-reduced over dp and dcn and averaged, and the
optimizer updates the rank's rows of the parameters in place (K4 once over
all of them).  Without a mesh, or without a process group, the step is the
one-device step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from .. import parallel
from ..pipelines import common
from . import edm, optimizers


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # mirrors config/train_image2video{,_gesturenet}.yaml (reference)
    learning_rate: float = 1e-5
    lr_warmup_steps: int = 500
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    noise_mean: float = 0.5
    noise_std: float = 1.4
    conditioning_dropout_prob: float = 0.1
    train_noise_aug_strength: float = 0.1
    process_fps: int = 7
    motion_bucket_id: int = 200
    max_grad_norm: Optional[float] = None  # 1.0 for VGL
    partial_finetune: bool = False
    use_text: bool = True
    gradient_accumulation_steps: int = 1
    # VGL sparse-conditioning experiments (train_csvd.py:834-886, off by default)
    mask_unet_vae: bool = False
    mask_controlnet_vae: bool = False
    mask_proportion: float = 0.0
    use_8bit_adam: bool = False  # block-quantised Adam state (bitsandbytes parity)


def _is_partial_trainable(name: str) -> bool:
    """Reference partial_finetune: a name part contains 'attn' or 'emb'."""
    return any("attn" in k or "emb" in k for k in name.split("."))


def make_optimizer(cfg: TrainConfig, params: Optional[Dict[str, Any]] = None, group=None):
    """The optax chain of the JAX trainer; ``params`` (name -> tensor) is
    needed for ``partial_finetune``'s labels; ``group``: the fsdp process
    group over which a sharded state's pieces are split (the clip's norm)."""
    schedule = optimizers.warmup_constant_schedule(cfg.learning_rate, cfg.lr_warmup_steps)
    make = optimizers.adamw8bit if cfg.use_8bit_adam else optimizers.adamw
    tx = make(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
              weight_decay=cfg.adam_weight_decay)
    if cfg.max_grad_norm is not None:
        tx = optimizers.chain(optimizers.clip_by_global_norm(cfg.max_grad_norm, group), tx)
    if cfg.partial_finetune:
        if params is None:
            raise ValueError("partial_finetune needs the parameter names")
        labels = {k: "train" if _is_partial_trainable(k) else "freeze" for k in params}
        tx = optimizers.multi_transform({"train": tx, "freeze": optimizers.set_to_zero()},
                                        labels)
    if cfg.gradient_accumulation_steps > 1:
        tx = optimizers.multi_steps(tx, cfg.gradient_accumulation_steps)
    return tx


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]  # the trainable model's, updated in place
    opt_state: Any  # of this rank's rows under a mesh (``rows``)
    rows: Optional[parallel.ShardedParams] = None  # the parameters' rows under a mesh

    def whole_params(self):
        """A context in which ``params`` are whole: under a mesh COLLECTIVE
        (every rank enters it), since the parameters rest split over fsdp."""
        return self.rows.whole() if self.rows is not None else contextlib.nullcontext()


def _distributed(mesh) -> bool:
    return mesh is not None and dist.is_available() and dist.is_initialized()


def init_train_state(model: torch.nn.Module, tx, mesh=None) -> TrainState:
    """Step 0; on a mesh of ranks ``model`` is split over fsdp
    (``parallel.shard_module``, collective) and the optimizer state is of
    this rank's rows of every leaf."""
    params = dict(model.named_parameters())
    if not _distributed(mesh):
        return TrainState(0, params, tx.init({k: p.detach() for k, p in params.items()}))
    rows = parallel.shard_module(model, mesh)
    return TrainState(0, params, tx.init(rows.views(rows.arena)), rows)


# train/inference fps skew is reference behaviour: training conditions on the
# raw process_fps (7), both inference pipelines on fps - 1
def make_add_time_ids(cfg: TrainConfig, motion_bucket_id, device=None) -> torch.Tensor:
    """[B, 3] micro-conditioning ids (fps, per-sample motion bucket, noise aug)."""
    motion = torch.as_tensor(motion_bucket_id, dtype=torch.float32, device=device).reshape(-1)
    b = motion.shape[0]
    return torch.stack([torch.full((b,), float(cfg.process_fps), device=motion.device),
                        motion,
                        torch.full((b,), cfg.train_noise_aug_strength, device=motion.device)],
                       dim=-1)


def _encode_conditioning_train(modules, frames, prompt_ids, use_text):
    """First frame -> CLIP states (joint LayerNorm with the text states)."""
    image_embeds = modules["image_encoder"](common.clip_preprocess(frames[:, 0]))
    text_states = None
    if use_text and prompt_ids is not None:
        text_states = modules["text_encoder"](prompt_ids)
    return common.build_encoder_hidden_states(image_embeds, text_states)


def _vae_encode_frames(vae, frames, scaling_factor):
    b, f = frames.shape[:2]
    lat = vae.encode_mode(frames.reshape(b * f, *frames.shape[2:]))
    return lat.reshape(b, f, *lat.shape[1:]) * scaling_factor


def _draw(draws, name, shape, generator, device, uniform=False, share=None):
    """The draw ``name`` for this rank's ``shape[0]`` rows: injected, or
    made from ``generator``.  ``share = (index, n)``: the rank is part
    ``index`` of ``n`` of the global batch; the draw is made (or injected)
    at the global shape and the rank keeps its rows."""
    idx, n = share or (0, 1)
    b = shape[0]
    if name in draws:
        t = torch.as_tensor(draws[name], dtype=torch.float32, device=device)
    else:
        fn = torch.rand if uniform else torch.randn
        t = fn((b * n,) + tuple(shape[1:]), generator=generator, device=device)
    return t[idx * b:(idx + 1) * b] if n > 1 else t


@torch.no_grad()
def _conditioning(modules, cfg: TrainConfig, batch, generator, draws, share=None):
    """Frozen encodes and EDM noising, shared by VL and VGL."""
    vae = modules["vae"]
    frames = batch["video_frames"].float()
    b, f = frames.shape[:2]
    dev = frames.device
    latents = _vae_encode_frames(vae, frames, vae.config.scaling_factor)
    first = frames[:, 0]
    first = first + _draw(draws, "aug", first.shape, generator, dev, share=share) \
        * cfg.train_noise_aug_strength
    cond_lat = vae.encode_mode(first)[:, None].repeat(1, f, 1, 1, 1)
    sigmas = edm.sample_sigmas(generator, b, cfg.noise_mean, cfg.noise_std,
                               normal=_draw(draws, "sigma", (b,), generator, dev, share=share))
    noise = _draw(draws, "noise", latents.shape, generator, dev, share=share)
    noisy, inp, timesteps = edm.edm_precondition(latents, noise, sigmas)
    states = _encode_conditioning_train(modules, frames, batch.get("prompt_ids"), cfg.use_text)
    if cfg.conditioning_dropout_prob:
        states, cond_lat = edm.conditioning_dropout(
            generator, states, cond_lat, cfg.conditioning_dropout_prob,
            uniform=_draw(draws, "dropout", (b,), generator, dev, uniform=True, share=share))
    add_ids = make_add_time_ids(cfg, batch["motion_bucket_id"], dev)
    return dict(latents=latents, noisy=noisy, inp=inp, timesteps=timesteps, sigmas=sigmas,
                states=states, cond_lat=cond_lat, add_ids=add_ids)


def _share(mesh):
    return (mesh.index(), mesh.size) if _distributed(mesh) else None


def _sharded_update(state: TrainState, loss, tx, mesh):
    """The step's gradients, update and new parameters on a mesh of ranks:
    -> (new opt state, global loss, global gradient norm)."""
    rows = state.rows
    loss.backward()  # each unit's gradients land in the rank's rows
    mine = rows.take_grads()
    dist.all_reduce(mine, group=mesh.group(*(a for a in mesh.axis_names if a != "fsdp")))
    mine /= mesh.size
    loss = loss.detach().clone()
    dist.all_reduce(loss)  # the mesh spans every rank
    loss /= mesh.size
    g = rows.views(mine)
    gnorm = optimizers.global_norm(g, rows.group)
    params = rows.views(rows.arena)
    updates, opt_state = tx.update(g, state.opt_state, params)
    optimizers.apply_updates(params, updates)
    return opt_state, loss, gnorm


def _make_step(tx, loss_fn, mesh=None) -> Callable:
    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None):
        """-> (state, {"loss", "grad_norm"}); ``grad_norm`` is the norm of
        the unclipped gradients.  Both metrics stay on the device; on a mesh
        both are the global batch's."""
        loss = loss_fn(batch, generator, draws or {})
        if state.rows is not None:
            opt_state, loss, gnorm = _sharded_update(state, loss, tx, mesh)
            return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                    {"loss": loss, "grad_norm": gnorm})
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        gnorm = optimizers.global_norm(grads)
        params = {k: p.detach() for k, p in state.params.items()}
        updates, opt_state = tx.update(grads, state.opt_state, params)
        optimizers.apply_updates(params, updates)
        return (dataclasses.replace(state, step=state.step + 1, opt_state=opt_state),
                {"loss": loss.detach(), "grad_norm": gnorm})

    step.loss_fn = loss_fn  # (batch, generator, draws) -> loss, for inspection
    return step


def make_vl_train_step(unet, modules: dict, tx, cfg: TrainConfig, mesh=None) -> Callable:
    """``step(state, batch, generator=None, draws=None)``; ``batch``:
    video_frames [B,F,H,W,3] in [-1,1], prompt_ids [B,77], motion_bucket_id
    [B] (this rank's rows on a ``mesh``); ``modules``: the frozen vae /
    image_encoder / text_encoder."""
    share = _share(mesh)

    def loss_fn(batch, generator, draws):
        c = _conditioning(modules, cfg, batch, generator, draws, share)
        inp = torch.cat([c["inp"], c["cond_lat"]], dim=-1)
        # every batch row is an independent clip: per-sample temporal context
        pred = unet(inp, c["timesteps"], c["states"], c["add_ids"],
                    context_clips=inp.shape[0])
        return edm.edm_loss(pred, c["noisy"], c["latents"], c["sigmas"])

    return _make_step(tx, loss_fn, mesh)


def make_vgl_train_step(unet, controlnet, modules: dict, tx, cfg: TrainConfig,
                        mesh=None) -> Callable:
    """VGL: the ControlNet trains, the UNet is frozen but stays in the
    gradient path (loss -> UNet -> residuals), so it runs with autograd on;
    ``batch`` also carries ``condition`` [B,F,H,W,3] in [0,1]."""
    share = _share(mesh)

    def loss_fn(batch, generator, draws):
        c = _conditioning(modules, cfg, batch, generator, draws, share)
        cond_lat = c["cond_lat"]
        b, f = cond_lat.shape[:2]
        dev = cond_lat.device
        cn_cond_lat = unet_cond_lat = cond_lat
        if cfg.mask_controlnet_vae or cfg.mask_unet_vae:
            # per-(frame, pixel) keep mask, channel-synchronised; with both
            # flags the UNet reuses the ControlNet's masked latents
            u = _draw(draws, "mask", (b, f) + tuple(cond_lat.shape[2:4]) + (1,), generator,
                      dev, uniform=True, share=share)
            masked = cond_lat * (u < (1.0 - cfg.mask_proportion)).to(cond_lat.dtype)
            if cfg.mask_controlnet_vae:
                cn_cond_lat = masked
            if cfg.mask_unet_vae:
                unet_cond_lat = masked
        cn_inp = torch.cat([c["inp"], cn_cond_lat], dim=-1)
        inp = torch.cat([c["inp"], unet_cond_lat], dim=-1)
        with torch.no_grad():  # gesture raster -> VAE latents (in [0, 1])
            cond_img = batch["condition"].float()
            glat = modules["vae"].encode_mode(cond_img.reshape(b * f, *cond_img.shape[2:]))
            gesture_lat = glat.reshape(b, f, *glat.shape[1:])
        res, mid = controlnet(cn_inp, c["timesteps"], c["states"], c["add_ids"], gesture_lat,
                              context_clips=b)
        pred = unet(inp, c["timesteps"], c["states"], c["add_ids"],
                    down_block_additional_residuals=res, mid_block_additional_residual=mid,
                    context_clips=b)
        return edm.edm_loss(pred, c["noisy"], c["latents"], c["sigmas"])

    return _make_step(tx, loss_fn, mesh)
