"""The port's YOLOv8 (``models/yolov8.py``) against the JAX module, on the CPU.

An ultralytics-layout state dict is made from a numpy seed with the port
module's own names and shapes; it reaches JAX through
``yolo_state_dict_to_flax`` and the port through ``load_state_dict(strict=
True)``.  Predictions agree within 1e-4; the weight round trip official ->
JAX -> port -> official is bit-equal; the host-side letterbox, NMS and box
scaling are exactly equal, and the cv2-free resize is within one uint8
level of ``cv2.resize``.
"""

import dataclasses
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.curation import detectors as jdet
from this_and_that_vdm_tpu.models import yolov8 as jyolo
from this_and_that_vdm_tpu.weights.convert import yolo_state_dict_to_flax

from this_and_that_vdm_tpu_torch.curation import detectors
from this_and_that_vdm_tpu_torch.data.image import resize_linear
from this_and_that_vdm_tpu_torch.models import yolov8
from this_and_that_vdm_tpu_torch.weights.convert import (flax_yolo_params_to_torch,
                                                         load_ultralytics_state_dict,
                                                         save_ultralytics_checkpoint)

from torch_one_thread import one_torch_thread  # noqa: F401

CFG = yolov8.YOLOv8Config.tiny(nc=2)


def official_state_dict(module: torch.nn.Module, seed: int = 0):
    """Seeded values under the module's own state-dict names (the DFL's
    fixed arange and the integer counters kept)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.is_floating_point() and ".dfl." not in k:
            a = rng.randn(*v.shape) * 0.1
            sd[k] = (np.abs(a) + 0.5 if k.endswith("running_var") else a).astype(np.float32)
        else:
            sd[k] = v.numpy()
    return sd


def same_scale(a, b):
    """The two configs give every layer the same width and repeat count."""
    return ((a.nc, a.reg_max) == (b.nc, b.reg_max)
            and all(a.ch(c) == b.ch(c) for c in (64, 128, 256, 512, 1024))
            and all(a.n(r) == b.n(r) for r in (3, 6)))


@pytest.fixture(scope="module")
def pair():
    model = yolov8.YOLOv8(CFG).eval()
    sd = official_state_dict(model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    params = yolo_state_dict_to_flax(sd)
    return sd, params, model


def test_predictions_match_jax(pair):
    _, params, model = pair
    img = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(jax.jit(jyolo.YOLOv8(CFG).apply)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 8 * 12 + 4 * 6 + 2 * 3, 4 + CFG.nc)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_weight_round_trip_is_bit_equal(pair):
    sd, params, model = pair
    back = flax_yolo_params_to_torch(params)
    assert set(back) == set(sd) == set(model.state_dict())
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k


def test_config_from_state_dict(pair):
    sd, _, _ = pair
    got = yolov8.YOLOv8Config.from_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(jyolo.YOLOv8Config.from_state_dict(sd))
    assert same_scale(got, CFG)


def test_shell_unpickler_reads_an_ultralytics_checkpoint(tmp_path, pair):
    """A checkpoint whose model claims an ultralytics class path, in fp16
    as ultralytics saves it, read without the package: names, fp32 upcast
    and the inferred scale."""
    sd, _, model = pair
    path = str(tmp_path / "gripper.pt")
    save_ultralytics_checkpoint(path, ema=model, train_args={"data": "x"},
                                best_fitness=np.float64(0.5))
    with open(path, "rb") as f:
        assert b"ultralytics.nn.modules" in f.read()
    assert type(model) is yolov8.YOLOv8 and next(model.parameters()).dtype == torch.float32
    got = load_ultralytics_state_dict(path)
    assert set(got) == set(sd)
    for k, v in sd.items():
        want = v.astype(np.float16).astype(np.float32) if v.dtype == np.float32 else v
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k
    assert same_scale(yolov8.YOLOv8Config.from_state_dict(got), CFG)
    yolov8.YOLOv8(CFG).load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                                       strict=True)


class _Payload:
    """Unpickles as a call of ``os.makedirs``: a global no checkpoint needs."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return os.makedirs, (self.path,)


def test_shell_unpickler_refuses_other_globals(tmp_path):
    """A file that names a global outside torch's tensor rebuilds, plain
    containers and module classes raises, and the call never runs."""
    path, target = str(tmp_path / "crafted.pt"), str(tmp_path / "made_by_the_file")
    torch.save({"model": torch.nn.Conv2d(3, 4, 1).half(), "train_args": _Payload(target)},
               path)
    with pytest.raises(pickle.UnpicklingError, match="os.makedirs|posix.makedirs"):
        load_ultralytics_state_dict(path)
    assert not os.path.exists(target)


def test_native_detector_matches_jax_wrapper(pair):
    _, params, model = pair
    det = detectors.NativeGripperDetector(model=model, imgsz=96, conf=0.3, device="cpu")
    jd = jdet.NativeGripperDetector(params=params, cfg=CFG, imgsz=96, conf=0.3)
    for seed, hw in ((1, (64, 96)), (2, (50, 70))):
        img = (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)
        want = jd.boxes_xywh(img)
        got = det.boxes_xywh(img)
        assert got.shape == want.shape and got.shape[1] == 4
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert len(want) > 0


def test_cuda_device_without_a_card_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        detectors.NativeGripperDetector(model=pair[2], device="cuda")


@pytest.mark.parametrize("hw,imgsz", [((480, 640), 640), ((64, 96), 96), ((50, 70), 96),
                                      ((70, 50), 64)])
def test_letterbox_matches_jax(hw, imgsz):
    img = (np.random.RandomState(3).rand(*hw, 3) * 255).astype(np.uint8)
    got, r, pad = yolov8.letterbox_np(img, imgsz)
    want, jr, jpad = jyolo.letterbox_np(img, imgsz)
    assert (r, pad, got.shape, got.dtype) == (jr, jpad, want.shape, want.dtype)
    if r == 1.0:  # no resize: the pads alone
        assert np.array_equal(got, want)
    else:  # the cv2-free INTER_LINEAR, one uint8 level at most
        assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("src,dst", [((50, 70), (69, 96)), ((480, 640), (320, 427)),
                                     ((31, 17), (64, 35)), ((64, 96), (64, 50))])
def test_resize_linear_within_one_level_of_cv2(src, dst):
    import cv2

    img = (np.random.RandomState(4).rand(*src, 3) * 255).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


def test_nms_and_scale_boxes_equal_jax():
    rng = np.random.RandomState(5)
    boxes = np.concatenate([rng.rand(300, 2) * 200, rng.rand(300, 2) * 40 + 5], 1)
    scores = rng.rand(300, 3).astype(np.float32)
    for conf, iou in ((0.25, 0.7), (0.5, 0.3), (0.99, 0.5)):
        got, want = yolov8.nms_np(boxes, scores, conf, iou), jyolo.nms_np(boxes, scores, conf, iou)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    args = (boxes[:20], 1.37, (8, 4), (150, 170))
    assert np.array_equal(yolov8.scale_boxes_np(*args), jyolo.scale_boxes_np(*args))
