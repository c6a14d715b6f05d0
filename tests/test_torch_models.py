"""The port's models (PyTorch, CPU, fp32) against the JAX modules.

Each JAX module's own ``init`` gives the parameter tree (its structure and
shapes, through ``jax.eval_shape``); the values are seeded numpy draws, so
zero-initialised convs and unit norms are non-trivial.  The tree goes to
the port through ``weights/convert.flax_params_to_torch``; both sides get
the same numpy inputs.  Tolerances from PARITY.md: 5e-5, 2e-5 for CLIP.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.models import clip as jclip
from this_and_that_vdm_tpu.models import controlnet as jcn
from this_and_that_vdm_tpu.models import unet as junet
from this_and_that_vdm_tpu.models import vae as jvae
from this_and_that_vdm_tpu.pipelines import common as jcommon

from this_and_that_vdm_tpu_torch.models import clip, controlnet, unet, vae
from this_and_that_vdm_tpu_torch.pipelines import common
from this_and_that_vdm_tpu_torch.weights.convert import load_flax_params
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

B, F, H, W = 2, 3, 8, 16  # CFG pair, 3 frames, 8x16 latent grid
CTX = 48


def _fill(path, sds, rng):
    """Seeded values for one leaf of a JAX init tree."""
    name = path[-1].key
    shape = sds.shape
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    if name in ("bias", "mix_factor", "class_embedding"):
        return 0.3 * rng.randn(*shape)
    if name == "embedding":
        return 0.5 * rng.randn(*shape)
    fan_in = int(np.prod(shape[:-1]))
    return rng.randn(*shape) / np.sqrt(fan_in)


def jax_params(module, *init_args, seed=0):
    """The JAX module's init tree with seeded numpy values."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(p, s, rng).astype(np.float32), shapes)


def port(torch_module, params):
    load_flax_params(torch_module, params)
    return torch_module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _unet_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, F, H, W, 8).astype(np.float32)
    ctx = rng.randn(B, 5, CTX).astype(np.float32)
    ids = np.tile(np.array([[6.0, 127.0, 0.02]], np.float32), (B, 1))
    return x, ctx, ids


@pytest.fixture(scope="module")
def controlnet_pair():
    """JAX and port GestureNets with one parameter tree, and the JAX
    residuals for a fixed input (scale 0.8)."""
    x, ctx, ids = _unet_inputs(1)
    cond = np.random.RandomState(2).randn(B, F, H, W, 4).astype(np.float32)
    jc = jcn.ControlNetModel(jcn.ControlNetConfig.tiny())
    params = jax_params(jc, x, 0.3, ctx, ids, cond, seed=1)
    jres, jmid = jax.jit(jc.apply)(params, x, 0.3, ctx, ids, cond, conditioning_scale=0.8)
    tc = port(controlnet.ControlNetModel(controlnet.ControlNetConfig.tiny()), params)
    return (x, ctx, ids, cond), tc, [np.asarray(r) for r in jres], np.asarray(jmid)


def _port_residuals(controlnet_pair, guess_mode):
    (x, ctx, ids, cond), tc, _, _ = controlnet_pair
    with torch.no_grad():
        return tc(_t(x), torch.tensor(0.3), _t(ctx), _t(ids), _t(cond),
                  conditioning_scale=0.8, guess_mode=guess_mode)


def test_controlnet_residuals_match_jax(controlnet_pair):
    _, _, jres, jmid = controlnet_pair
    tres, tmid = _port_residuals(controlnet_pair, guess_mode=False)
    assert len(tres) == len(jres) == 12
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5)
    np.testing.assert_allclose(tmid.numpy(), jmid, atol=5e-5)


def test_controlnet_guess_mode_scales_match_jax_rule(controlnet_pair):
    """guess_mode: residual i scaled by logspace(-1, 0, 13)[i], mid by 1.0
    (models/controlnet.py:220-223), on top of conditioning_scale."""
    _, _, jres, jmid = controlnet_pair
    tres, tmid = _port_residuals(controlnet_pair, guess_mode=True)
    scales = np.logspace(-1, 0, len(jres) + 1)
    for a, b, s in zip(tres, jres, scales):
        np.testing.assert_allclose(a.numpy(), b * s, atol=5e-5)
    np.testing.assert_allclose(tmid.numpy(), jmid, atol=5e-5)


def test_unet_with_controlnet_residuals_matches_jax(controlnet_pair):
    (x, ctx, ids, _), _, jres, jmid = controlnet_pair
    jm = junet.UNetSpatioTemporalConditionModel(junet.UNetConfig.tiny())
    params = jax_params(jm, x, 0.3, ctx, ids, seed=2)
    want = np.asarray(jax.jit(jm.apply)(params, x, 0.3, ctx, ids,
                                        down_block_additional_residuals=jres,
                                        mid_block_additional_residual=jmid))
    tm = port(unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.tiny()), params)
    with torch.no_grad():
        got = tm(_t(x), torch.tensor(0.3), _t(ctx), _t(ids),
                 down_block_additional_residuals=[_t(r) for r in jres],
                 mid_block_additional_residual=_t(jmid)).numpy()
    assert got.shape == (B, F, H, W, 4)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.fixture(scope="module")
def vae_pair():
    jm = jvae.AutoencoderKLTemporalDecoder(jvae.VAEConfig.tiny())
    params = jax_params(jm, np.zeros((1, 32, 64, 3), np.float32),
                        np.zeros((1, 2, 4, 8, 4), np.float32), seed=3)
    return jm, params, port(vae.AutoencoderKLTemporalDecoder(vae.VAEConfig.tiny()), params)


def test_vae_encode_mode_matches_jax(vae_pair):
    jm, params, tm = vae_pair
    x = np.clip(np.random.RandomState(4).randn(2, 32, 64, 3) * 0.5, -1, 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: jm.apply(p, a, method="encode_mode"))(params, x))
    with torch.no_grad():
        got = tm.encode_mode(_t(x)).numpy()
    assert got.shape == (2, 4, 8, 4)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_vae_chunked_decode_with_ragged_chunk_matches_jax(vae_pair):
    jm, params, tm = vae_pair
    z = np.random.RandomState(5).randn(1, 5, 4, 8, 4).astype(np.float32)  # chunks 2, 2, 1
    decode = jax.jit(lambda p, c: jm.apply(p, c, method="decode"))
    want = np.asarray(jcommon.decode_latents_chunked(
        lambda c: decode(params, c), jnp.asarray(z), 0.18215, 2))
    with torch.no_grad():
        got = common.decode_latents_chunked(tm.decode, _t(z), 0.18215, 2).numpy()
    assert got.shape == (1, 5, 32, 64, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_clip_text_matches_jax():
    cfg = jclip.CLIPTextConfig.tiny()
    ids = np.array([[1, 5, 9, 3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                    [7, 2, 2, 60, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]], np.int32)
    jm = jclip.CLIPTextModel(cfg)
    params = jax_params(jm, ids, seed=6)
    want = np.asarray(jm.apply(params, ids))
    tm = port(clip.CLIPTextModel(clip.CLIPTextConfig.tiny()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_clip_vision_matches_jax():
    px = np.random.RandomState(7).randn(2, 32, 32, 3).astype(np.float32)
    jm = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.tiny())
    params = jax_params(jm, px, seed=7)
    want = np.asarray(jm.apply(params, px))
    tm = port(clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig.tiny()), params)
    with torch.no_grad():
        got = tm(_t(px)).numpy()
    assert got.shape == (2, 24)
    np.testing.assert_allclose(got, want, atol=2e-5)
