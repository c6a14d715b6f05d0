"""The port's baked VGL (standard; guess + ip2p gated) and VL pipelines
against the JAX pipelines with ``bake_params=True`` (fp32 on the CPU, the
tiny configs of ``tests/test_torch_pipeline.py``, PARITY.md's 2e-4), no
graph captured.  ``test_torch_bake_one_clip.py`` and
``test_torch_bake_two_clips.py`` run them at 1 and 2 clips: each clip count
compiles its own baked JAX programs (~40 s a program on one core), so the
two files take two test workers.  The pipeline builders and inputs serve
``test_torch_bake.py`` too.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from this_and_that_vdm_tpu.pipelines import StableVideoDiffusionPipeline as JaxVL

from this_and_that_vdm_tpu_torch.pipelines import (
    StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline)

from test_torch_pipeline import FR, H, IDS, KW, W

VGL_MODES = [
    dict(controlnet_conditioning_scale=0.8),
    dict(guess_mode=True, use_instructpix2pix=True, image_guidance_scale=2.0,
         control_guidance_end=0.6),
]
VGL_IDS = ["standard", "guess_ip2p_gated"]


def _vgl(t, bake=True):
    return StableVideoDiffusionControlNetPipeline(
        t["unet"], t["vae"], t["image_encoder"], t["controlnet"], t["text_encoder"],
        bake_params=bake)


def _vl(t, bake=True):
    return StableVideoDiffusionPipeline(t["unet"], t["vae"], t["image_encoder"],
                                        t["text_encoder"], bake_params=bake)


def _inputs(seed, clips):
    rng = np.random.RandomState(seed)
    image = np.clip(rng.randn(clips, H, W, 3) * 0.3, -1, 1).astype(np.float32)
    cond_img = rng.rand(FR, H, W, 3).astype(np.float32)
    noise = rng.randn(clips, FR, H // 8, W // 8, 4).astype(np.float32)
    return image, cond_img, noise, dict(KW, prompt_ids=np.repeat(IDS, clips, axis=0))


@pytest.fixture(scope="module")
def baked_jax(pipes):
    """One baked JAX pipeline for the module: its compiled programs are
    cached across the tests."""
    return dataclasses.replace(pipes[0], bake_params=True)


def check_baked_vgl(pipes, baked_jax, mode, clips):
    t = pipes[1]
    image, cond_img, noise, kw = _inputs(1, clips)
    want = baked_jax(image, cond_img, latents=jnp.asarray(noise), **mode, **kw)
    pipe = _vgl(t)
    got = pipe(image, cond_img, latents=noise, **mode, **kw)
    assert got.shape == (clips, FR, H, W, 3) == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the CPU runs the step eagerly: no graph, nothing cached
    assert pipe.captures == 0 and pipe.step_graphs() == []


def check_baked_vl(pipes, baked_jax, clips):
    t = pipes[1]
    image, _, noise, kw = _inputs(0, clips)
    want = JaxVL.__call__(baked_jax, image, latents=jnp.asarray(noise), **kw)
    pipe = _vl(t)
    got = pipe(image, latents=noise, **kw)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert pipe.captures == 0 and pipe.step_graphs() == []
