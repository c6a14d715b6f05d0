"""The port's VL train step (PyTorch, CPU, fp32) against the JAX package:
the UNet finetune at nano size with 8-bit AdamW, three steps on the same
parameters, batches and random draws (set-up and tolerances in
``torch_train_harness.py``)."""

import pytest

import torch_train_harness as h
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def trained():
    return h.trained("vl", h.build_towers())


def test_vl_step_one_matches_jax(trained):
    setup, out, first, _ = trained
    h.check_step_one(setup, out, first)


def test_vl_three_step_losses_match_jax(trained):
    h.check_three_losses(trained[1])


def test_vl_step_trains_the_unet_with_8bit_state(trained):
    setup, _, _, unet_before = trained
    h.check_trainable_only(setup, unet_before)


def test_vl_adam8bit_state_converter(trained):
    h.check_state_converter(trained[0])
