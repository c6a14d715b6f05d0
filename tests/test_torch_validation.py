"""The port's ``training/validation.render_validation`` against the JAX
package's, with a recording stub pipeline in both (CPU): for each instance
the pipeline receives the same inputs (the image within one uint8 level,
the gesture condition within 1e-5, the prompt ids exactly, the same sampling
arguments), and the two file trees written are the same, their PNGs equal
pixel for pixel.  Instances without ``im_0.jpg`` are skipped, and in VGL
those without ``data.txt``."""

import os

import cv2
import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu.training import validation as jvalidation

from this_and_that_vdm_tpu_torch.cli.tokenizer import hash_tokenizer
from this_and_that_vdm_tpu_torch.training import validation
from this_and_that_vdm_tpu_torch.utils import video_io

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

FR, H, W = 3, 32, 48
LEVEL = 1.0 / 127.5


class _Recorder:
    """Records each call; answers with frames that depend on the call's
    index only, so both packages write the same files."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def __call__(self, image, *args, **kw):
        self.calls.append((np.asarray(image), [np.asarray(a) for a in args], kw))
        rng = np.random.RandomState(len(self.calls))
        return rng.randint(0, 256, (1, kw["num_frames"], H, W, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def instances(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    rng = np.random.RandomState(0)
    for name, hw, gesture, lang in [("a_task", (120, 160), True, "pick up the red block"),
                                    ("b_task", (97, 131), True, ""),
                                    ("c_nodata", (64, 80), False, "open the drawer"),
                                    ("d_noimage", None, True, "x")]:
        d = root / name
        d.mkdir()
        if hw is not None:
            img = cv2.GaussianBlur((rng.rand(*hw, 3) * 255).astype(np.uint8), (5, 5), 2)
            if name == "b_task":  # PNG bytes under the .jpg name
                video_io.write_png(str(d / "im_0.jpg"), img)
            else:
                cv2.imwrite(str(d / "im_0.jpg"), img)
        (d / "lang.txt").write_text(lang + "\n")
        if gesture:
            (d / "data.txt").write_text("0 30.0 40.0\n2 60.5 20.25\n")
    return str(root)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode", ["vl", "vgl"])
def test_render_validation_matches_jax(instances, tmp_path, mode):
    tok = hash_tokenizer()
    kw = dict(mode=mode, num_frames=FR, height=H, width=W, num_inference_steps=3,
              motion_bucket_id=127, seed=5)
    got_pipe, want_pipe = _Recorder(), _Recorder()
    got = validation.render_validation(7, str(tmp_path / "port"), got_pipe, instances, tok, **kw)
    want = jvalidation.render_validation(7, str(tmp_path / "jax"), want_pipe, instances, tok,
                                         **kw)
    names = ["a_task", "b_task"] + (["c_nodata"] if mode == "vl" else [])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == names
    assert len(got_pipe.calls) == len(want_pipe.calls) == len(names)
    for (gi, ga, gk), (wi, wa, wk) in zip(got_pipe.calls, want_pipe.calls):
        assert gi.shape == wi.shape == (1, H, W, 3) and gi.dtype == np.float32
        assert np.abs(gi - wi).max() <= LEVEL * 1.0001
        assert len(ga) == len(wa) == (1 if mode == "vgl" else 0)
        for a, b in zip(ga, wa):  # the gesture condition
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(gk.pop("prompt_ids"), wk.pop("prompt_ids"))
        gen, key = gk.pop("generator"), wk.pop("key")
        assert gen.initial_seed() == 5 and np.asarray(key).tolist() == [0, 5]
        assert gk == wk
    assert _tree(str(tmp_path / "port")) == _tree(str(tmp_path / "jax"))
    for rel in _tree(str(tmp_path / "port")):
        if rel.endswith(".png"):
            a = video_io.read_png(str(tmp_path / "port" / rel))
            b = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / rel)), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(a, b)
    assert _tree(str(tmp_path / "port")).count("step_7/a_task/combined.gif") == 1


def test_render_validation_keeps_train_mode_and_autograd(instances, tmp_path):
    """A render through the real pipeline leaves the trainable model in train
    mode and autograd on (tiny models, mixed dtypes: bf16 frozen UNet, fp32
    GestureNet, as in VGL training)."""
    from this_and_that_vdm_tpu_torch.models import cast_compute_dtype
    from this_and_that_vdm_tpu_torch.weights import loader

    models = loader.random_models("tiny", "cpu")
    for name in ("unet", "vae", "image_encoder", "text_encoder"):
        cast_compute_dtype(models[name], torch.bfloat16)
    models["gesturenet"].train().requires_grad_(True)
    pipe = loader.make_pipeline(models, "vgl")
    tok = hash_tokenizer()
    out = validation.render_validation(1, str(tmp_path), pipe, instances, tok, mode="vgl",
                                       num_frames=FR, height=64, width=64,
                                       num_inference_steps=1, max_instances=1)
    assert len(out) == 1 and len(video_io.load_frames_dir(out[0])) == FR
    assert models["gesturenet"].training and not models["unet"].training
    assert torch.is_grad_enabled()
    assert all(p.requires_grad for p in models["gesturenet"].parameters())
