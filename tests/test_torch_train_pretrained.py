"""Training from a weight folder and a dataset tree (CPU, tiny models).

- A tiny HF-layout tree from the port's ``cli/rehearsal.synthesize_hf_repo``
  (fp16 variant, tokenizer included) loads through
  ``weights/loader.load_training_models`` and through the JAX
  ``weights/loader.load_pretrained``: every tensor bit-equal after
  ``weights/convert``; the trainable model fp32 with gradients on, the
  frozen ones in the frozen dtype without.
- ``train_loop.main --pretrained --tiny --device cpu`` on a Bridge-layout
  tree with ``validation_step: 1``: 2 steps, checkpoints, a validation
  render at each step, then a resume to step 3.
- A tree without ``gesturenet/`` and a tokenizer path that is not a local
  folder raise.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from this_and_that_vdm_tpu.weights import loader as jloader

from this_and_that_vdm_tpu_torch.cli import rehearsal
from this_and_that_vdm_tpu_torch.data.image import resize_bicubic
from this_and_that_vdm_tpu_torch.training import train_loop
from this_and_that_vdm_tpu_torch.utils import video_io
from this_and_that_vdm_tpu_torch.weights import loader
from this_and_that_vdm_tpu_torch.weights.convert import flax_params_to_torch

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

FR, H, W = 3, 64, 128


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return rehearsal.synthesize_hf_repo(str(tmp_path_factory.mktemp("hf") / "weights"), "tiny",
                                        variant="fp16", device="cpu")


def _jax_states(tree, mode):
    # the JAX loader reads gesturenet/ when it is given a ControlNet module
    frozen, unet, cn = jloader.load_pretrained(tree, None, object(), None, mode=mode)
    out = {k: flax_params_to_torch(v) for k, v in frozen.items()}
    out["unet"] = flax_params_to_torch(unet)
    if cn is not None:
        out["gesturenet"] = flax_params_to_torch(cn)
    return out


@pytest.mark.parametrize("mode", ["vl", "vgl"])
def test_training_models_bit_equal_to_jax_loader(tree, mode):
    unet, cn, modules = loader.load_training_models(tree, mode, loader.model_configs("tiny"),
                                                    "cpu", torch.float32)
    got = dict(modules, unet=unet, **({"gesturenet": cn} if cn is not None else {}))
    want = _jax_states(tree, mode)
    assert set(got) == set(want)
    for name, module in got.items():
        state = module.state_dict()
        assert set(state) == set(want[name]), name
        for k, v in want[name].items():
            np.testing.assert_array_equal(state[k].numpy(), v.reshape(state[k].shape),
                                          err_msg=f"{name}.{k}")
    trainable = unet if mode == "vl" else cn
    assert trainable.training and all(p.requires_grad for p in trainable.parameters())
    frozen = [m for m in got.values() if m is not trainable]
    assert not any(m.training or any(p.requires_grad for p in m.parameters()) for m in frozen)


def test_frozen_dtype_and_remat_configs(tree):
    """bf16 frozen towers and UNet (matmul / conv weights; norms fp32), the
    GestureNet fp32, the configs' ``remat`` kept."""
    configs = loader.model_configs("tiny")
    configs["unet"] = configs["unet"].__class__(**{**vars(configs["unet"]), "remat": True})
    unet, cn, modules = loader.load_training_models(tree, "vgl", configs, "cpu", torch.bfloat16)
    assert unet.config.remat and unet.conv_in.weight.dtype == torch.bfloat16
    assert modules["vae"].encoder.conv_in.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in cn.parameters())
    want = _jax_states(tree, "vgl")["unet"]["conv_in.weight"]
    assert torch.equal(unet.conv_in.weight, torch.from_numpy(want).to(torch.bfloat16))


def test_missing_gesturenet_raises(tree, tmp_path):
    root = str(tmp_path / "no_gesturenet")
    shutil.copytree(tree, root, ignore=shutil.ignore_patterns("gesturenet"))
    with pytest.raises(FileNotFoundError, match="gesturenet"):
        loader.load_training_models(root, "vgl", loader.model_configs("tiny"), "cpu")
    unet, cn, _ = loader.load_training_models(root, "vl", loader.model_configs("tiny"), "cpu")
    assert cn is None and unet.training


def _instance(d, rng, n=FR, gesture=True):
    os.makedirs(d)
    for i in range(n):
        img = resize_bicubic((rng.rand(6, 8, 3) * 255).astype(np.uint8), 96, 128)
        video_io.write_png(os.path.join(d, f"im_{i}.jpg"), img)
    with open(os.path.join(d, "lang.txt"), "w") as f:
        f.write("push the cup to the plate\n")
    if gesture:
        with open(os.path.join(d, "data.txt"), "w") as f:
            f.write("0 30.0 40.0\n2 90.0 70.0\n")


def _config(tmp_path, tree, **over):
    rng = np.random.RandomState(0)
    data, val = tmp_path / "data", tmp_path / "val"
    if not data.exists():
        for i in range(3):
            _instance(str(data / f"inst{i}"), rng)
        _instance(str(val / "v0"), rng)
    cfg = dict(video_seq_length=FR, height=H, width=W, train_batch_size=1, num_train_iters=2,
               checkpointing_steps=1, checkpoints_total_limit=2, learning_rate=1e-4,
               lr_warmup_steps=1, seed=42, use_8bit_adam=True, mixed_precision="bf16",
               output_dir=str(tmp_path / "out"), use_text=True, motion_bucket_id=200,
               dataset_path=[str(data)], pretrained_tokenizer_name_or_path=tree,
               validation_step=1, validation_img_folder=str(val), num_inference_steps=1,
               dataloader_num_workers=2, validation_store_folder="validation_videos")
    cfg.update(over)
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


@pytest.mark.parametrize("mode", ["vgl", "vl"])
def test_train_loop_pretrained_bridge_validation_and_resume(tree, tmp_path, mode, capsys):
    seen = {}

    def on_step(step, state, m, models):
        if step == 0:
            seen["trainable0"] = {k: p.detach().clone() for k, p in state.params.items()}
        else:
            seen.setdefault("waits", []).append(m["data_wait_s"])

    args = ["--mode", mode, "--tiny", "--pretrained", tree, "--device", "cpu"]
    state = train_loop.main(["--config", _config(tmp_path, tree), "--max-steps", "2"] + args,
                            on_step=on_step)
    assert state.step == 2 and len(seen["waits"]) == 2 and min(seen["waits"]) >= 0
    out = tmp_path / "out"
    assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    for step in (1, 2):
        d = out / "validation_videos" / f"step_{step}" / "v0"
        frames = video_io.load_frames_dir(str(d))
        assert len(frames) == FR and frames[0].shape == (H, W, 3)
        assert (d / "combined.gif").exists()
    metrics = [json.loads(line) for line in open(out / "logging" / "metrics.jsonl")]
    assert metrics and all(np.isfinite(m["loss"]) for m in metrics)
    assert "waited" in capsys.readouterr().out
    # step 0 held the tree's weights (fp16 values, in fp32)
    want = _jax_states(tree, mode)["unet" if mode == "vl" else "gesturenet"]
    for k, v in seen["trainable0"].items():
        np.testing.assert_array_equal(v.numpy(), want[k].reshape(v.shape))

    state = train_loop.main(["--config", _config(tmp_path, tree, resume_from_checkpoint="latest"),
                             "--max-steps", "3"] + args)
    assert state.step == 3 and "checkpoint-3" in os.listdir(out)
    assert os.path.isdir(out / "validation_videos" / "step_3" / "v0")


def test_train_loop_tokenizer_must_be_a_local_folder(tree, tmp_path):
    cfg = _config(tmp_path, tree,
                  pretrained_tokenizer_name_or_path="RedbeardNZ/stable-diffusion-2-1-base")
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        train_loop.main(["--config", cfg, "--mode", "vgl", "--tiny", "--pretrained", tree,
                         "--device", "cpu", "--max-steps", "1"])
