"""Block-quantised 8-bit AdamW and the optax pieces the trainers chain.

Counterpart of ``this_and_that_vdm_tpu/training/optimizers.py`` and of the
optax transformations that ``training/trainer.py`` builds on.  A
transformation is an ``(init, update)`` pair over parameter dicts (name ->
tensor), as in optax: ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``, chained left to right.  An update
takes ownership of the ``updates`` dict it is given: it may replace its
entries and change their tensors in place.  Each transformation repeats
optax's arithmetic operation for operation, so an fp32 run matches the JAX
package to rounding.

8-bit Adam state: per parameter, the first moment as signed and the second
as unsigned codes of the closed-form log codebook (``ops/quant8.py``), one
uint8 per element padded to whole 256-element blocks, plus one fp32 absmax
scale per block, ``Q(q uint8 [nb * 256], scale fp32 [nb])``.  The update of
every leaf is one K4 call (``ops/adam8bit.py``): one Hopper launch on CUDA,
its plain version on the CPU.

Blocks run over the torch flattening of each parameter (dense ``(O, I)``,
conv ``(O, I, H, W)``), as the reference's bitsandbytes optimizer blocks
them; the JAX package blocks its flax layout (``(I, O)``, ``(H, W, I, O)``).
The first step from a zero state does not depend on the layout, and 1-D
leaves match exactly; later steps of transposed leaves differ by the
quantisation noise of the moments (``weights/convert.py``
``flax_adam8bit_state_to_torch`` carries a JAX state over).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import adam8bit as k4
from ..ops.quant8 import BLOCK, decode, encode

_N_MAGS = {True: 127, False: 255}


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def chain(*txs) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]):
    """``p + u`` in place (optax ``apply_updates``)."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def global_norm(tree: Dict[str, torch.Tensor], group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (a device scalar).
    ``group``: the process group over which the leaves are split in pieces
    (a rank's block rows under fsdp): the sums of squares are all-reduced
    over it first."""
    sq = sum(torch.sum(t.float() * t.float()) for t in tree.values())
    if group is not None and tree:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


# ----------------------------------------------------------------- schedules

def warmup_constant_schedule(lr: float, warmup_steps: int) -> Callable[[int], np.float32]:
    """optax ``join_schedules([linear_schedule(0, lr, W), constant(lr)], [W])``
    in fp32: ``schedule(0) = 0`` whenever ``W > 0``."""
    def schedule(count: int) -> np.float32:
        if warmup_steps <= 0 or count >= warmup_steps:
            return np.float32(lr)
        frac = np.float32(1.0) - np.float32(max(count, 0)) / np.float32(warmup_steps)
        return np.float32(0.0 - lr) * frac + np.float32(lr)

    return schedule


# ------------------------------------------------------------ transformations

def scale_by_schedule(step_size_fn) -> GradientTransformation:
    """Multiply by ``step_size_fn(count)``, read before the count
    increments (so the first update uses ``step_size_fn(0)``)."""
    def update(updates, count, params=None):
        step_size = float(step_size_fn(count))
        for k in updates:
            updates[k] = updates[k].mul_(step_size)
        return updates, count + 1

    return GradientTransformation(lambda params: 0, update)


def scale_by_learning_rate(schedule) -> GradientTransformation:
    return scale_by_schedule(lambda count: -schedule(count))


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        # in place: the 8-bit step of every leaf is a view of one arena, which
        # a new tensor a leaf would keep alive beside a second full copy
        for k in updates:
            updates[k] = updates[k].add_(params[k].detach() * weight_decay)
        return updates, state

    return GradientTransformation(lambda params: (), update)


def clip_by_global_norm(max_norm: float, group=None) -> GradientTransformation:
    """optax ``clip_by_global_norm``; ``group`` as in :func:`global_norm`."""
    def update(updates, state, params=None):
        g_norm = global_norm(updates, group)
        trigger = g_norm < max_norm
        for k, t in updates.items():
            updates[k] = torch.where(trigger, t, (t / g_norm) * max_norm)
        return updates, state

    return GradientTransformation(lambda params: (), update)


def set_to_zero() -> GradientTransformation:
    def update(updates, state, params=None):
        return {k: torch.zeros_like(t) for k, t in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """fp32 Adam (optax ``scale_by_adam``, eps_root 0)."""
    def init(params):
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for k, p in params.items()}
        return AdamState(0, zeros(), zeros())

    def update(updates, state, params=None):
        count = state.count + 1
        bc1, bc2 = k4.bias_corrections(count, b1, b2)
        mu, nu = {}, {}
        for k, g in updates.items():
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * state.nu[k]
            updates[k] = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


class Q(NamedTuple):
    q: torch.Tensor  # uint8 codebook indices, padded flat [n_blocks * BLOCK]
    scale: torch.Tensor  # fp32 per-block absmax [n_blocks]


def _quantize(x: torch.Tensor, signed: bool = True) -> Q:
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1)
    safe = torch.where(scale > 0, scale, 1.0)
    q = encode(blocks / safe[:, None], signed, _N_MAGS[signed])
    return Q(q.to(torch.uint8).reshape(-1), scale)


def _dequantize(qv: Q, shape, signed: bool = True) -> torch.Tensor:
    blocks = decode(qv.q.reshape(-1, BLOCK).float(), signed, _N_MAGS[signed])
    n = int(np.prod(shape))
    return (blocks * qv.scale[:, None]).reshape(-1)[:n].reshape(shape)


class Adam8bitState(NamedTuple):
    count: int
    mu: Dict[str, Q]  # signed codebook
    nu: Dict[str, Q]  # unsigned codebook


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """8-bit Adam moments and step of every leaf in one K4 call (one launch
    on CUDA); the new moments are views of the call's arenas; on CUDA the
    steps overwrite the gradients."""
    def init(params):
        zeros = lambda p, s: _quantize(torch.zeros_like(p, dtype=torch.float32), s)  # noqa: E731
        return Adam8bitState(0, {k: zeros(p, True) for k, p in params.items()},
                             {k: zeros(p, False) for k, p in params.items()})

    def update(updates, state, params=None):
        count = state.count + 1
        bc = k4.bias_corrections(count, b1, b2)
        keys = list(updates)
        mu, nu = [state.mu[k] for k in keys], [state.nu[k] for k in keys]
        gs = [updates[k].reshape(-1).float() for k in keys]
        # on the card each step overwrites its gradient (the chain owns
        # ``updates``): no second tree-sized buffer beside the gradients
        steps, mq2, ms2, nq2, ns2 = k4.adam8bit_leaves(
            gs, [q.q for q in mu], [q.scale for q in mu], [q.q for q in nu],
            [q.scale for q in nu], bc, b1, b2, eps,
            out=gs if gs and gs[0].is_cuda else None)
        for i, k in enumerate(keys):
            updates[k] = steps[i].view(updates[k].shape)
        return updates, Adam8bitState(
            count, {k: Q(mq2[i], ms2[i]) for i, k in enumerate(keys)},
            {k: Q(nq2[i], ns2[i]) for i, k in enumerate(keys)})

    return GradientTransformation(init, update)


def adamw8bit(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2):
    return chain(scale_by_adam8bit(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


def adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


# ------------------------------------------------------------------ wrappers

def multi_transform(transforms: Dict[str, GradientTransformation],
                    labels: Dict[str, str]) -> GradientTransformation:
    """optax ``multi_transform``: each label's transformation sees only the
    parameters of that label."""
    def split(tree, label):
        return {k: v for k, v in tree.items() if labels[k] == label}

    def init(params):
        return {lab: tx.init(split(params, lab)) for lab, tx in transforms.items()}

    def update(updates, state, params=None):
        out, new = {}, {}
        for lab, tx in transforms.items():
            sub, new[lab] = tx.update(split(updates, lab), state[lab],
                                      None if params is None else split(params, lab))
            out.update(sub)
        return {k: out[k] for k in updates}, new

    return GradientTransformation(init, update)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: object
    acc_grads: Dict[str, torch.Tensor]


def multi_steps(tx: GradientTransformation, k_steps: int) -> GradientTransformation:
    """optax ``MultiSteps``: average ``k_steps`` gradients (Welford mean) and
    apply the inner transformation on every ``k_steps``-th call; the other
    calls emit zero updates."""
    def init(params):
        return MultiStepsState(0, 0, tx.init(params),
                               {k: torch.zeros_like(p) for k, p in params.items()})

    def update(updates, state, params=None):
        n = state.mini_step
        acc = {k: a + (updates[k] - a) / float(n + 1) for k, a in state.acc_grads.items()}
        if n != k_steps - 1:
            zeros = {k: torch.zeros_like(u) for k, u in updates.items()}
            return zeros, state._replace(mini_step=n + 1, acc_grads=acc)
        out, inner = tx.update(dict(acc), state.inner_opt_state, params)
        return out, MultiStepsState(0, state.gradient_step + 1, inner,
                                    {k: torch.zeros_like(a) for k, a in acc.items()})

    return GradientTransformation(init, update)
