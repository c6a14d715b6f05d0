"""The port's weight loader (weights/loader.py) against the JAX loader, on
an HF-layout tree that the JAX rehearsal writes (tiny configs, fp16
variant): the same state dicts bit for bit, a strict load that refuses a
missing tensor, CLIP ``position_ids`` dropped, and the VGL pipelines built
from the two loads within 2e-4 of each other (PARITY.md's full-pipeline
bound), with the same injected latents and image noise."""

import argparse
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.cli import inference as jinference
from this_and_that_vdm_tpu.cli.rehearsal import synthesize_hf_repo
from this_and_that_vdm_tpu.weights import loader as jloader

from this_and_that_vdm_tpu_torch.cli.tokenizer import CLIPTokenizer
from this_and_that_vdm_tpu_torch.weights import loader, safetensors_io as sio
from this_and_that_vdm_tpu_torch.weights.convert import flax_params_to_torch

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

B, FR, H, W = 1, 3, 64, 128
STEPS = 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthesize_hf_repo(str(tmp_path_factory.mktemp("hf") / "weights"), "tiny",
                              variant="fp16")


def _jax_state(tree, name):
    if name in ("image_encoder", "text_encoder"):
        params = jloader.load_clip_params(tree, name)
    else:
        params = getattr(jloader, {"unet": "load_unet_params", "vae": "load_vae_params",
                                   "gesturenet": "load_gesturenet_params"}[name])(tree)
    return flax_params_to_torch(params)


def _port(tree, name, **kw):
    kw = dict(scale="tiny", device="cpu", **kw)
    if name in ("image_encoder", "text_encoder"):
        return loader.load_clip(tree, name, **kw)
    return getattr(loader, f"load_{name}")(tree, **kw)


@pytest.mark.parametrize("name", ["unet", "gesturenet", "vae", "image_encoder",
                                  "text_encoder"])
def test_state_dict_bit_equal_to_jax_loader(tree, name):
    want = _jax_state(tree, name)
    got = _port(tree, name).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        t = got[k]
        assert t.dtype == torch.float32 and tuple(t.shape) == v.shape, k
        assert np.array_equal(t.numpy().view(np.int32), np.asarray(v, np.float32).view(np.int32)), k


def _copy_folder(tree, tmp_path, sub):
    root = tmp_path / "w"
    shutil.copytree(os.path.join(tree, sub), root / sub)
    (path,) = [os.path.join(root, sub, f) for f in os.listdir(root / sub)]
    return str(root), path


def test_strict_load_refuses_a_missing_tensor(tree, tmp_path):
    root, path = _copy_folder(tree, tmp_path, "vae")
    state = sio.load_file(path)
    state.pop(sorted(state)[3])
    sio.save_file(state, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        loader.load_vae(root, scale="tiny", device="cpu")


def test_clip_position_ids_are_dropped(tree, tmp_path):
    root, path = _copy_folder(tree, tmp_path, "text_encoder")
    state = sio.load_file(path)
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sio.save_file(state, path)
    got = loader.load_clip(root, "text_encoder", scale="tiny", device="cpu").state_dict()
    want = _port(tree, "text_encoder").state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_compute_dtype_casts_matmuls_and_keeps_norms_fp32(tree):
    unet = _port(tree, "unet", dtype=torch.bfloat16)
    assert unet.conv_in.weight.dtype == torch.bfloat16
    assert unet.conv_norm_out.weight.dtype == torch.float32
    assert unet.conv_in.weight.device.type == "cpu" and not unet.conv_in.weight.requires_grad


def test_vgl_pipeline_from_loaded_weights_matches_jax(tree):
    args = argparse.Namespace(model_type="GestureNet", pretrained=tree, random_weights=False,
                              model_scale="tiny", dtype="f32", num_frames=FR, height=H,
                              width=W, no_bake=True)
    jax_pipe = jinference.build_pipeline(args)
    pipe = loader.load_pretrained(tree, "vgl", "cpu", torch.float32, scale="tiny")
    rng = np.random.RandomState(3)
    image = np.clip(rng.randn(B, H, W, 3) * 0.3, -1, 1).astype(np.float32)
    cond = rng.rand(FR, H, W, 3).astype(np.float32)
    latents = rng.randn(B, FR, H // 8, W // 8, 4).astype(np.float32)
    image_noise = rng.randn(B, H, W, 3).astype(np.float32)
    ids = CLIPTokenizer.from_pretrained(tree)(["pick up the red block"])
    kw = dict(prompt_ids=ids, num_frames=FR, num_inference_steps=STEPS, fps=7,
              motion_bucket_id=200, noise_aug_strength=0.1, decode_chunk_size=2)
    want = np.asarray(jax_pipe(image, cond, latents=jnp.asarray(latents),
                               image_noise=image_noise, **kw))
    got = pipe(image, cond, latents=latents, image_noise=image_noise, **kw)
    assert got.shape == (B, FR, H, W, 3) == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
