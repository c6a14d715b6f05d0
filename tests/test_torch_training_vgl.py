"""The port's VGL train step (PyTorch, CPU, fp32) against the JAX package:
the GestureNet finetune over a frozen UNet at nano size with 8-bit AdamW and
the grad-norm clip, three steps on the same parameters, batches and random
draws, plus one step with the sparse-conditioning masks (set-up and
tolerances in ``torch_train_harness.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_harness as h
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def towers():
    return h.build_towers()


@pytest.fixture(scope="module")
def trained(towers):
    return h.trained("vgl", towers)


def test_vgl_step_one_matches_jax(trained):
    setup, out, first, _ = trained
    h.check_step_one(setup, out, first)


def test_vgl_three_step_losses_match_jax(trained):
    h.check_three_losses(trained[1])


def test_vgl_step_leaves_the_unet_bitwise(trained):
    setup, _, _, unet_before = trained
    h.check_trainable_only(setup, unet_before)


def test_vgl_adam8bit_state_converter(trained):
    h.check_state_converter(trained[0])


def test_vgl_masked_conditioning_step_matches_jax(towers):
    """Both masks on (the UNet reuses the GestureNet's masked latents), the
    keep mask drawn from the same key: step-1 loss and grad_norm, and the
    mask reaches the loss."""
    setup = h.Setup(towers, "vgl", mask_unet_vae=True, mask_controlnet_vae=True,
                    mask_proportion=0.3)
    b, key = h.batch(7, True), jax.random.PRNGKey(7)
    d = h.draws(key, mask=True)
    jl, jg, _ = setup.jax_step({k: jnp.asarray(v) for k, v in b.items()}, key, update=False)
    with torch.no_grad():
        unmasked = float(setup.tstep.loss_fn({k: torch.from_numpy(v) for k, v in b.items()},
                                             None, dict(d, mask=np.ones_like(d["mask"]))))
    tl, tg = setup.torch_step(b, d)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    assert unmasked != tl
