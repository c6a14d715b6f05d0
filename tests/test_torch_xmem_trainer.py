"""The port's XMem trainer (``training/xmem_trainer.py``) against the JAX
one, on the CPU.

The losses within 1e-5 (the bootstrapped CE before, inside and after its
warm-up, with a dead object channel masked); ``_ref_mask``'s rules; and one
full step of both packages on the same weights and batch (2 clips of 4
frames at 64x48, 2 objects, the second dead in clip 2), at settings where
JAX's ``jax.random`` draws are fixed (T = num_ref_frames + 1, deep-update
probability 1) and before the warm-up (a bootstrapped CE's pixel selection
would make the gradient flip with last-bit differences):

  * the losses and the gradient norm within 1e-4 relative;
  * every trained leaf's gradient (the batch norms' ``mean`` / ``var``
    included, which the JAX step trains) within 1e-3 of the leaf's largest
    JAX gradient plus 1e-6 of the global norm (leaves whose gradient is 0
    but for rounding, such as the key projection's bias);
  * each side's parameters after the update equal to one AdamW step on its
    own gradient, within 1e-5 of the learning rate: Adam's first step is
    ``lr * sign(g)`` for all but the smallest gradients, so the two
    packages' leaves are compared through their gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from this_and_that_vdm_tpu.models import xmem as jxm
from this_and_that_vdm_tpu.training import trainer as jtrainer
from this_and_that_vdm_tpu.training import xmem_trainer as jxt
from this_and_that_vdm_tpu.weights.convert import xmem_state_dict_to_flax

from this_and_that_vdm_tpu_torch.models import xmem as xm
from this_and_that_vdm_tpu_torch.training import xmem_trainer as xt
from this_and_that_vdm_tpu_torch.weights.convert import flax_xmem_params_to_torch

from test_torch_xmem import port_xmem, seeded_state_dict
from torch_one_thread import one_torch_thread  # noqa: F401

H, W, T, N, B = 64, 48, 4, 2, 2
GRAD_TOL = 1e-3    # relative to the leaf's largest JAX gradient,
GRAD_FLOOR = 1e-6  # plus this share of the global norm (leaves whose gradient is 0 but for noise)


def test_dice_loss_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.rand(2, 3, 16, 12).astype(np.float32)
    gt = rng.randint(0, 4, (2, 16, 12)).astype(np.int64)
    want = float(jxt.dice_loss(jnp.asarray(m), jnp.asarray(gt)))
    assert abs(float(xt.dice_loss(torch.from_numpy(m), torch.from_numpy(gt))) - want) < 1e-6


@pytest.mark.parametrize("it", [0, 45000, 99999])
def test_bootstrapped_ce_matches_jax(it):
    """Before (plain CE), inside (annealing) and after the warm-up; the
    second sample's last channel is dead (num_classes 3 of 4)."""
    rng = np.random.RandomState(it % 97)
    logits = rng.randn(2, 4, 16, 12).astype(np.float32)
    target = rng.randint(0, 3, (2, 16, 12))
    ncls = np.array([4, 3])
    want, wp = jxt.bootstrapped_ce(jnp.asarray(logits), jnp.asarray(target), it, 20000, 70000,
                                   num_classes=jnp.asarray(ncls))
    got, p = xt.bootstrapped_ce(torch.from_numpy(logits), torch.from_numpy(target), it, 20000,
                                70000, num_classes=torch.from_numpy(ncls))
    assert float(p) == float(wp)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_ref_mask_rules():
    gen = torch.Generator().manual_seed(0)
    b, slots, num_ref = 4, 7, 3
    for ti in (1, 2, 3, 5, 7):
        for _ in range(5):
            m = xt._ref_mask(gen, b, slots, ti, num_ref)
            assert m.shape == (b, slots)
            assert (m[:, 0] == 1).all() and (m[:, ti:] == 0).all()
            assert (m.sum(1) == min(ti, num_ref)).all()


def batch():
    rng = np.random.RandomState(1)
    rgb = (rng.randn(B, T, H, W, 3) * 0.5).astype(np.float32)
    gt0 = (rng.rand(B, N, H, W) > 0.7).astype(np.float32)
    gt0[1, 1] = 0.0
    cls_gt = rng.randint(0, N + 1, (B, T, H, W)).astype(np.int32)
    cls_gt[1] = np.minimum(cls_gt[1], 1)  # clip 2 has one live object
    return dict(rgb=rgb, first_frame_gt=gt0, cls_gt=cls_gt,
                selector=np.array([[1.0, 1.0], [1.0, 0.0]], np.float32),
                num_objects=np.array([2, 1], np.int32))


def test_train_step_matches_jax():
    with torch.device("meta"):
        names = xm.XMem()
    sd = seeded_state_dict(names, seed=2)
    cfg = dict(start_warm=1, end_warm=3, num_ref_frames=T - 1, deep_update_prob=1.0,
               learning_rate=1e-3, weight_decay=0.05)
    it = 0  # before the warm-up: a plain CE, whose gradient has no pixel selection to flip
    data = batch()

    jcfg = jxt.XMemTrainConfig(**cfg)
    tx = jxt.make_optimizer(jcfg)
    state = jtrainer.init_train_state(jax.tree.map(jnp.asarray, xmem_state_dict_to_flax(sd)), tx)
    step = jxt.make_xmem_train_step(jxm.XMem(), tx, jcfg)
    state, want = step(state, {k: jnp.asarray(v) for k, v in data.items()}, jnp.int32(it),
                       jax.random.PRNGKey(3))
    after = flax_xmem_params_to_torch(jax.tree.map(np.asarray, state.params))

    model = port_xmem({k: v.copy() for k, v in sd.items()}).train()  # trained in place
    opt = xt.make_optimizer(model, xt.XMemTrainConfig(**cfg))
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    got = xt.train_step(model, opt, tb, it, xt.XMemTrainConfig(**cfg),
                        torch.Generator().manual_seed(0))

    for k in ("total_loss", "ce_loss", "dice_loss", "p", "n_frames", "grad_norm"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-4 * abs(w), (k, float(got[k]), w)

    # the gradients: JAX's from its first Adam moment (mu = (1 - b1) g), the
    # port's left on its leaves (the batch norms' statistics among them)
    adam = next(s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    jgrad = flax_xmem_params_to_torch(jax.tree.map(lambda m: np.asarray(m) / 0.1, adam.mu))
    leaves = dict(model.named_parameters())
    leaves.update((k, v) for k, v in model.named_buffers() if v.requires_grad)
    assert len(leaves) == len([k for k in after if not k.endswith("num_batches_tracked")])
    lr, wd = cfg["learning_rate"], cfg["weight_decay"]
    port = model.state_dict()
    for k, leaf in leaves.items():
        g, w = leaf.grad.numpy(), jgrad[k]
        assert np.abs(w).max() > 0, k  # every leaf is trained, the statistics too
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max()
                                   + GRAD_FLOOR * float(want["grad_norm"]), err_msg=k)
        # one AdamW step from zero moments on each side's own gradient:
        # p - lr * (g / (|g| + eps) + wd * p), bias corrections included.
        # optax takes 1 - 0.999 in float32 (1.3e-5 off), hence 1e-5 of lr
        for p_after, grad in ((port[k].numpy(), g), (after[k], w)):
            p0, g64 = sd[k].astype(np.float64), grad.astype(np.float64)
            expect = p0 - lr * (g64 / (np.abs(g64) + 1e-8) + wd * p0)
            np.testing.assert_allclose(p_after, expect, rtol=0, atol=1e-5 * lr + 1e-6 * np.abs(
                p0).max(), err_msg=k)
