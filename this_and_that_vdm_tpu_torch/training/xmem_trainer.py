"""XMem finetuning: the losses and the teacher-forced multi-frame train step
(counterpart of ``training/xmem_trainer.py``; reference
track_anything_code/tracker/model/losses.py and trainer.py:60-150).

  * bootstrapped cross-entropy with its warm-up: plain CE before
    ``start_warm``, then the hardest ``this_p`` share of each sample's
    pixels, ``this_p`` falling linearly from 1 to ``top_p`` by ``end_warm``;
  * dice loss over every object channel with the +1 smoothing;
  * the forward: frame 0's value from the ground-truth masks; every later
    frame read against the memory of the earlier frames (frame 0 always,
    then ``num_ref_frames`` picked at random), segmented, and written back
    from its own prediction, with a deep hidden update drawn at
    ``deep_update_prob``.

The draws come from an explicit CPU ``torch.Generator`` (no host sync on
the card).  JAX draws with ``jax.random``, which the port cannot replay: at
T <= num_ref_frames + 1 and ``deep_update_prob`` 0 or 1 both steps draw
nothing that matters, and compute the same thing.

The JAX step trains the frozen batch norms' statistics: ``FrozenBatchNorm``
keeps ``mean`` and ``var`` as parameters and ``optax.adamw`` has no mask,
so they get gradients, Adam moments and weight decay.  The port's
``FrozenBatchNorm2d`` holds them as buffers; ``trainable_tensors`` hands
them to the optimizer (with ``requires_grad``) beside the parameters, so
the port trains the same leaves.  The reference trains its BN in eval mode
and does not update these; the quirk is kept, not fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models import xmem as xm
from ..models.frozen_bn import FrozenBatchNorm2d


@dataclasses.dataclass(frozen=True)
class XMemTrainConfig:
    start_warm: int = 20000
    end_warm: int = 70000
    top_p: float = 0.15
    num_ref_frames: int = 3
    deep_update_prob: float = 0.2
    learning_rate: float = 1e-5
    weight_decay: float = 0.05


# -------------------------------------------------------------------- losses


def dice_loss(mask_prob: torch.Tensor, cls_gt: torch.Tensor) -> torch.Tensor:
    """mask_prob ``[B, N, H, W]`` (per object, no background), cls_gt
    ``[B, H, W]`` (0 background, i+1 object i) -> mean over (sample, object)."""
    n = mask_prob.shape[1]
    labels = torch.arange(1, n + 1, device=cls_gt.device)
    gt = (cls_gt[:, None] == labels[None, :, None, None]).float().flatten(2)
    m = mask_prob.flatten(2)
    num = 2.0 * (m * gt).sum(-1)
    den = m.sum(-1) + gt.sum(-1)
    return (1.0 - (num + 1.0) / (den + 1.0)).mean()


def _this_p(it: int, start_warm: int, end_warm: int, top_p: float) -> torch.Tensor:
    """The kept share, in float32 as the JAX schedule computes it."""
    it_t = torch.tensor(float(it), dtype=torch.float32)
    if it < start_warm:
        return torch.tensor(1.0)
    if it > end_warm:
        return torch.tensor(top_p, dtype=torch.float32)
    return top_p + (1.0 - top_p) * (end_warm - it_t) / (end_warm - start_warm)


def bootstrapped_ce(logits: torch.Tensor, target: torch.Tensor, it: int, start_warm: int,
                    end_warm: int, top_p: float = 0.15,
                    num_classes: Optional[torch.Tensor] = None):
    """Per-sample bootstrapped CE (losses.py:23-43), batched: logits
    ``[B, C, H, W]``, target ``[B, H, W]``; channels at or above
    ``num_classes[b]`` are left out of sample b's softmax.  Returns (mean
    over B, this_p)."""
    b, c = logits.shape[:2]
    if num_classes is not None:
        chan_ok = torch.arange(c, device=logits.device)[None, :] < num_classes[:, None]
        logits = logits.masked_fill(~chan_ok[:, :, None, None], float("-inf"))
    logp = F.log_softmax(logits, dim=1)
    raw = -torch.gather(logp, 1, target[:, None].long())[:, 0].reshape(b, -1)
    p = _this_p(it, start_warm, end_warm, top_p)
    k = max(int(raw.shape[1] * p), 1)  # float32 product, truncated, as in JAX
    per_sample = torch.topk(raw, k, dim=1).values.sum(1) / k
    return per_sample.mean(), p


def xmem_losses(logits_seq: List[torch.Tensor], masks_seq: List[torch.Tensor],
                cls_gt: torch.Tensor, it: int, cfg: XMemTrainConfig,
                num_objects: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """LossComputer.compute (losses.py:46-68) over the T-1 supervised
    frames: logits ``[B, 1+N, H, W]`` and masks ``[B, N, H, W]`` a frame,
    cls_gt ``[B, T, H, W]``."""
    ncls = None if num_objects is None else num_objects + 1
    ce, dice, ps = [], [], []
    for t, (lg, ms) in enumerate(zip(logits_seq, masks_seq), start=1):
        c, p = bootstrapped_ce(lg, cls_gt[:, t], it, cfg.start_warm, cfg.end_warm,
                               cfg.top_p, ncls)
        ce.append(c)
        dice.append(dice_loss(ms, cls_gt[:, t]))
        ps.append(p)
    ce, dice = torch.stack(ce), torch.stack(dice)
    return dict(total_loss=ce.sum() + dice.sum(), ce_loss=ce.mean(), dice_loss=dice.mean(),
                p=torch.stack(ps).mean(), n_frames=torch.tensor(float(len(logits_seq))))


# ---------------------------------------------------------- the forward


def _ref_mask(generator: torch.Generator, b: int, slots: int, ti: int,
              num_ref: int) -> torch.Tensor:
    """``[B, slots]`` 0/1: the memory slots frame ``ti`` reads.  Slots at or
    after ``ti`` are never picked; past ``num_ref`` valid slots, ``num_ref``
    are picked at random with slot 0 always among them (trainer.py's
    ``filler_one``).  Drawn on the CPU."""
    pri = torch.rand(b, slots, generator=generator)
    idx = torch.arange(slots)[None, :]
    pri = torch.where(idx == 0, -1.0, pri)
    pri = torch.where(idx >= ti, 2.0, pri)
    rank = torch.argsort(torch.argsort(pri, dim=1), dim=1)
    return (rank < min(ti, num_ref)).float()


def forward_losses(model: xm.XMem, batch: Dict[str, torch.Tensor], it: int,
                   cfg: XMemTrainConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The teacher-forced forward and its losses.  ``batch``: rgb
    ``[B, T, H, W, 3]`` ImageNet-normalised, first_frame_gt ``[B, N, H, W]``,
    cls_gt ``[B, T, H, W]`` int, selector ``[B, N]`` (1 = live object),
    num_objects ``[B]`` (optional)."""
    rgb = batch["rgb"].permute(0, 1, 4, 2, 3)  # [B, T, 3, H, W]
    gt0, selector = batch["first_frame_gt"], batch["selector"]
    b, t = rgb.shape[:2]
    n_obj = gt0.shape[1]
    key, shrink, select, f16, f8, f4 = model.encode_key(rgb.flatten(0, 1))
    hq, wq = key.shape[-2:]
    p_tok = hq * wq

    def per_frame(x):  # [B*T, ...] -> [B, T, ...]
        return x.reshape(b, t, *x.shape[1:])

    keys, select = per_frame(xm.tokens(key)), per_frame(xm.tokens(select))
    shrink = shrink.reshape(b, t, p_tok)
    f16, f8, f4 = per_frame(f16), per_frame(f8), per_frame(f4)

    hidden = key.new_zeros(b, n_obj, model.hidden_dim, hq, wq)
    v0, hidden = model.encode_value(rgb[:, 0], f16[:, 0], hidden, gt0, True)
    slots = t - 1
    values = [xm.tokens(v0)] + [None] * (slots - 1)  # [B, N, P, CV] a slot
    mem_keys = keys[:, :slots].reshape(b, slots * p_tok, -1)
    mem_shrink = shrink[:, :slots].reshape(b, slots * p_tok)

    logits_seq, masks_seq = [], []
    for ti in range(1, t):
        tok_mask = _ref_mask(generator, b, slots, ti, cfg.num_ref_frames).to(key.device)
        tok_mask = tok_mask.repeat_interleave(p_tok, dim=1)
        sim = xm.key_similarity(mem_keys, mem_shrink, keys[:, ti], select[:, ti])
        affinity = F.softmax(sim.masked_fill(tok_mask[:, None, :] == 0, float("-inf")), -1)
        mem_v = torch.cat([v if v is not None else torch.zeros_like(values[0])
                           for v in values], 2)  # [B, N, slots*P, CV]
        readout = torch.einsum("bpn,bonc->bopc", affinity, mem_v)
        readout = readout.transpose(2, 3).reshape(b, n_obj, -1, hq, wq)
        hidden, logits, masks = model.segment(f16[:, ti], f8[:, ti], f4[:, ti], readout,
                                              hidden, True, True, selector)
        logits_seq.append(logits)
        masks_seq.append(masks)
        if ti < slots:  # frame ti's value and deep update (the last frame's are never read)
            v16, h_deep = model.encode_value(rgb[:, ti], f16[:, ti], hidden, masks, True)
            if float(torch.rand((), generator=generator)) < cfg.deep_update_prob:
                hidden = h_deep
            values[ti] = xm.tokens(v16)
    return xmem_losses(logits_seq, masks_seq, batch["cls_gt"], it, cfg,
                       batch.get("num_objects"))


# ------------------------------------------------------------ the optimizer


def trainable_tensors(model: xm.XMem) -> List[torch.Tensor]:
    """The leaves the JAX step trains: every parameter, and every frozen
    batch norm's ``running_mean`` / ``running_var`` (``requires_grad`` set on
    them here, so call it after moving the model)."""
    out = list(model.parameters())
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm2d):
            for buf in (m.running_mean, m.running_var):
                buf.requires_grad_(True)
                out.append(buf)
    return out


def make_optimizer(model: xm.XMem, cfg: XMemTrainConfig) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)``: betas (0.9, 0.999), eps 1e-8
    outside the square root, decay on every leaf."""
    return torch.optim.AdamW(trainable_tensors(model), lr=cfg.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def train_step(model: xm.XMem, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
               it: int, cfg: XMemTrainConfig,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One step: the losses, their gradient over every trained leaf, its
    global norm, one AdamW update.  Returns the losses and ``grad_norm``
    (tensors on the model's device)."""
    optimizer.zero_grad(set_to_none=True)
    losses = forward_losses(model, batch, it, cfg, generator)
    losses["total_loss"].backward()
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]
             if p.grad is not None]
    losses["grad_norm"] = torch.sqrt(sum(g.square().sum() for g in grads))
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}
