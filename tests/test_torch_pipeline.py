"""The port's VGL and VL pipelines (PyTorch, CPU, fp32) against the JAX
pipelines, end to end: conditioning encode, the Euler loop with the
ControlNet, chunked decode.  Same dims as tests/test_pipeline_parity.py
(B=1, F=3, 64x128, 3 steps, chunk 2), the same injected latents and
noise_aug_strength=0 on both sides; parameter trees from the JAX modules'
init (seeded values) carried by weights/convert.  Tolerance 2e-4 (PARITY.md).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.models import clip as jclip
from this_and_that_vdm_tpu.models import controlnet as jcn
from this_and_that_vdm_tpu.models import unet as junet
from this_and_that_vdm_tpu.models import vae as jvae
from this_and_that_vdm_tpu.pipelines import (
    StableVideoDiffusionControlNetPipeline as JaxVGL, StableVideoDiffusionPipeline as JaxVL)

from this_and_that_vdm_tpu_torch.models import clip, controlnet, unet, vae
from this_and_that_vdm_tpu_torch.pipelines import (
    StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline)

from test_torch_models import jax_params, port
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

B, FR, H, W = 1, 3, 64, 128
CTX = 48
STEPS = 3
CHUNK = 2
IDS = np.array([[1, 5, 9, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]])


@pytest.fixture(scope="module")
def pipes():
    lat = np.zeros((2, FR, H // 8, W // 8, 8), np.float32)
    ctx = np.zeros((2, 2, CTX), np.float32)
    ids = np.zeros((2, 3), np.float32)
    vis_cfg = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                   patch_size=56, image_size=224, projection_dim=CTX)
    txt_cfg = dict(vocab_size=64, hidden_size=CTX, num_layers=2, num_heads=4,
                   intermediate_size=64, max_positions=16)
    j = dict(
        unet=junet.UNetSpatioTemporalConditionModel(junet.UNetConfig.tiny()),
        controlnet=jcn.ControlNetModel(jcn.ControlNetConfig.tiny()),
        vae=jvae.AutoencoderKLTemporalDecoder(jvae.VAEConfig.tiny()),
        image_encoder=jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**vis_cfg)),
        text_encoder=jclip.CLIPTextModel(jclip.CLIPTextConfig(**txt_cfg)),
    )
    p = dict(
        unet=jax_params(j["unet"], lat, 0.5, ctx, ids, seed=10),
        controlnet=jax_params(j["controlnet"], lat, 0.5, ctx, ids, lat[..., :4], seed=11),
        vae=jax_params(j["vae"], np.zeros((1, H, W, 3), np.float32), lat[:1, :2, ..., :4],
                       seed=12),
        image_encoder=jax_params(j["image_encoder"], np.zeros((1, 224, 224, 3), np.float32),
                                 seed=13),
        text_encoder=jax_params(j["text_encoder"], IDS, seed=14),
    )
    jax_pipe = JaxVGL(unet=j["unet"], vae=j["vae"], image_encoder=j["image_encoder"],
                      text_encoder=j["text_encoder"], controlnet=j["controlnet"],
                      unet_params=p["unet"], vae_params=p["vae"],
                      image_encoder_params=p["image_encoder"],
                      text_encoder_params=p["text_encoder"], controlnet_params=p["controlnet"])
    t = dict(
        unet=port(unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.tiny()), p["unet"]),
        controlnet=port(controlnet.ControlNetModel(controlnet.ControlNetConfig.tiny()),
                        p["controlnet"]),
        vae=port(vae.AutoencoderKLTemporalDecoder(vae.VAEConfig.tiny()), p["vae"]),
        image_encoder=port(clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(**vis_cfg)),
                           p["image_encoder"]),
        text_encoder=port(clip.CLIPTextModel(clip.CLIPTextConfig(**txt_cfg)),
                          p["text_encoder"]),
    )
    return jax_pipe, t


def _inputs(seed):
    rng = np.random.RandomState(seed)
    image = np.clip(rng.randn(B, H, W, 3) * 0.3, -1, 1).astype(np.float32)
    cond_img = rng.rand(FR, H, W, 3).astype(np.float32)
    noise = rng.randn(B, FR, H // 8, W // 8, 4).astype(np.float32)
    return image, cond_img, noise


KW = dict(prompt_ids=IDS, num_frames=FR, num_inference_steps=STEPS, fps=7,
          motion_bucket_id=200, noise_aug_strength=0.0, decode_chunk_size=CHUNK)


@pytest.mark.parametrize("mode", [
    dict(controlnet_conditioning_scale=0.8),
    # ControlNet on the conditional branch only (first in the 3-way ip2p
    # layout), zero residuals elsewhere, gated off after 60% of the steps
    dict(guess_mode=True, use_instructpix2pix=True, image_guidance_scale=2.0,
         control_guidance_end=0.6),
], ids=["standard", "guess_ip2p_gated"])
def test_vgl_pipeline_matches_jax(pipes, mode):
    jax_pipe, t = pipes
    image, cond_img, noise = _inputs(1)
    want = jax_pipe(image, cond_img, latents=jnp.asarray(noise), **mode, **KW)
    pipe = StableVideoDiffusionControlNetPipeline(
        t["unet"], t["vae"], t["image_encoder"], t["controlnet"], t["text_encoder"])
    trace = {}
    got = pipe(image, cond_img, latents=noise, trace=trace, **mode, **KW)
    assert got.shape == (B, FR, H, W, 3) == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert {"cond_encode", "gesture_encode", "denoise", "decode", "uint8_host"} <= set(trace)
    assert torch.isfinite(trace["latents"]).all()


def test_vl_pipeline_matches_jax(pipes):
    jax_pipe, t = pipes
    image, _, noise = _inputs(0)
    want = JaxVL.__call__(jax_pipe, image, latents=jnp.asarray(noise), **KW)
    pipe = StableVideoDiffusionPipeline(t["unet"], t["vae"], t["image_encoder"],
                                        t["text_encoder"])
    got = pipe(image, latents=noise, **KW)
    np.testing.assert_allclose(got, want, atol=2e-4)
