"""The port's entry points on the CPU (fp32, tiny models, 2 steps): the
batch-inference CLI with ``--random-weights`` and with ``--pretrained`` over
a tree from the port's ``synthesize_hf_repo``; the rehearsal chain (A = B
passes the PSNR >= 35 gate, the perturbed C fails it); the port's PSNR,
SSIM and ``evaluate_trees`` against the JAX ones on the same trees
(rel 1e-6); eval's LPIPS flags refused without a weight file (the LPIPS
itself is in ``test_torch_lpips.py``); the sweep."""

import json
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from this_and_that_vdm_tpu.cli import eval as jeval
from this_and_that_vdm_tpu.utils import video_io as jvideo_io

from this_and_that_vdm_tpu_torch.cli import eval as eval_cli
from this_and_that_vdm_tpu_torch.cli import inference, rehearsal, sweep
from this_and_that_vdm_tpu_torch.utils import video_io

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

FR, H, W = 3, 64, 128
COMMON = ["--device", "cpu", "--dtype", "f32", "--height", str(H), "--width", str(W),
          "--num-frames", str(FR), "--num-inference-steps", "2"]


@pytest.fixture(scope="module")
def instances(tmp_path_factory):
    """Two instance folders: im_0.jpg written by cv2, lang.txt, data.txt."""
    root = tmp_path_factory.mktemp("val")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(240, 320), (301, 457)]):
        d = root / f"Task{i}"
        d.mkdir()
        img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8), (9, 9), 3)
        cv2.imwrite(str(d / "im_0.jpg"), img)
        (d / "lang.txt").write_text(["pick up the red block", "push the cup left"][i] + "\n")
        (d / "data.txt").write_text(f"0 {w // 3} {h // 2}\n{FR - 1} {w // 2} {h // 3}\n")
    (root / "not_an_instance").mkdir()
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return rehearsal.synthesize_hf_repo(str(tmp_path_factory.mktemp("hf") / "weights"),
                                        "tiny", variant="fp16", device="cpu")


def _check_outputs(outs, store, prompts):
    assert [os.path.basename(o) for o in outs] == ["Task0", "Task1"]
    for out, prompt in zip(outs, prompts):
        frames = video_io.load_frames_dir(out)
        assert len(frames) == FR and all(f.shape == (H, W, 3) for f in frames)
        assert all(np.array_equal(f, cv2.cvtColor(cv2.imread(os.path.join(out, f"{i}.png")),
                                                  cv2.COLOR_BGR2RGB))
                   for i, f in enumerate(frames))
        with Image.open(os.path.join(out, "combined.gif")) as gif:
            assert gif.n_frames == FR and gif.size == (W, H)
        with open(os.path.join(out, "lang_cond.txt")) as f:
            assert f.read() == prompt + "\n"
    assert not os.path.exists(os.path.join(store, "not_an_instance"))


def test_inference_random_weights(instances, tmp_path):
    store = str(tmp_path / "out")
    outs = inference.main(["--random-weights", "--validation-path", instances,
                           "--store-dir", store] + COMMON)
    _check_outputs(outs, store, ["pick up the red block", "push the cup left"])


def test_inference_pretrained_vl_ambiguous_prompt(instances, tree, tmp_path):
    store = str(tmp_path / "out")
    outs = inference.main(["--pretrained", tree, "--model-scale", "tiny", "--model-type",
                           "UNet", "--use-ambiguous-prompt", "--validation-path", instances,
                           "--store-dir", store] + COMMON)
    _check_outputs(outs, store, ["pick this to there", "push this to there"])


def test_inference_needs_weights():
    with pytest.raises(SystemExit):
        inference.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def renders(instances, tmp_path_factory):
    """The rehearsal chain, outputs kept: A, B (same weights) and C
    (perturbed UNet)."""
    out = str(tmp_path_factory.mktemp("rehearsal"))
    rc = rehearsal.main(["--out", out, "--device", "cpu", "--frames", str(FR),
                         "--validation-path", instances, "--keep"])
    return rc, {x: os.path.join(out, f"render_{x}") for x in "abc"}


def test_rehearsal_gate_passes_same_weights_and_fails_perturbed(renders):
    rc, dirs = renders
    assert rc == 0
    ab = eval_cli.evaluate_trees(dirs["a"], dirs["b"], psnr_gate=35.0)
    ac = eval_cli.evaluate_trees(dirs["a"], dirs["c"], psnr_gate=35.0)
    assert ab["gate_pass"] and ab["n_instances"] == 2 and ab["psnr_min"] == 99.0
    assert not ac["gate_pass"] and ac["psnr_min"] < 35.0


@pytest.mark.parametrize("pair", ["ab", "ac"])
def test_evaluate_trees_matches_jax(renders, pair):
    _, dirs = renders
    a, b = dirs[pair[0]], dirs[pair[1]]
    got = eval_cli.evaluate_trees(a, b, psnr_gate=35.0)
    want = jeval.evaluate_trees(a, b, psnr_gate=35.0)
    assert set(got) == set(want) and got["gate_pass"] == want["gate_pass"]
    for key in ("psnr_mean", "psnr_min", "ssim_mean"):
        assert got[key] == pytest.approx(want[key], rel=1e-6)
    for name in want["instances"]:
        fa, fb = video_io.load_frames_dir(os.path.join(a, name)), jvideo_io.load_frames_dir(
            os.path.join(b, name))
        m, jm = video_io.per_frame_metrics(fa, fb), jvideo_io.per_frame_metrics(fa, fb)
        np.testing.assert_allclose(m["psnr"], jm["psnr"], rtol=1e-6)
        np.testing.assert_allclose(m["ssim"], jm["ssim"], rtol=1e-6)


def test_psnr_ssim_match_jax():
    rng = np.random.RandomState(5)
    a = cv2.GaussianBlur((rng.rand(64, 96, 3) * 255).astype(np.uint8), (5, 5), 2)
    b = np.clip(a.astype(int) + rng.randint(-9, 10, a.shape), 0, 255).astype(np.uint8)
    assert video_io.psnr(a, b) == pytest.approx(jvideo_io.psnr(a, b), rel=1e-6)
    assert video_io.ssim(a, b) == pytest.approx(jvideo_io.ssim(a, b), rel=1e-6)
    assert video_io.psnr(a, a) == float("inf")


def test_eval_main_gate_exit_codes_and_lpips_refused(renders, tmp_path):
    _, dirs = renders
    out = str(tmp_path / "report.json")
    assert eval_cli.main([dirs["a"], dirs["b"], "--psnr-gate", "35", "--out", out]) == 0
    with open(out) as f:
        assert json.load(f)["gate_pass"]
    assert eval_cli.main([dirs["a"], dirs["c"], "--psnr-gate", "35"]) == 1
    with pytest.raises(FileNotFoundError):
        eval_cli.main([dirs["a"], dirs["b"], "--lpips-weights", str(tmp_path / "w.pth"),
                       "--device", "cpu"])


def test_sweep_writes_one_record_per_setting(instances, tmp_path):
    out = str(tmp_path / "sweep.json")
    frames = str(tmp_path / "frames")
    res = sweep.main(["--random-weights", "--model-type", "GestureNet", "--instance",
                      os.path.join(instances, "Task1"), "--steps", "1", "2", "--guidance",
                      "3.0", "--out", out, "--save-frames", frames] + COMMON[:-2])
    with open(out) as f:
        assert json.load(f) == res
    assert [r["steps"] for r in res] == [1, 2] and all(r["device"] == "cpu" for r in res)
    assert len(os.listdir(frames)) == 2
    shutil.rmtree(frames)
