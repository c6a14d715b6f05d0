"""The port's gesture rasteriser, bicubic resize, header-size reader and
instance-image loader (numpy only) against the JAX package's cv2 versions:
rasters within 1e-5 on [0, 1]; the instance image within one uint8 level
(1 / 127.5 after scaling to [-1, 1])."""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from this_and_that_vdm_tpu.cli.inference import _load_instance_image as jax_instance_image
from this_and_that_vdm_tpu.data import rasterize as jr

from this_and_that_vdm_tpu_torch.cli.inference import _load_instance_image
from this_and_that_vdm_tpu_torch.data import image, rasterize
from this_and_that_vdm_tpu_torch.utils import video_io

TARGET = (256, 384)
POINTS = {"one": [(0, 150.7, 120.2)],
          "two": [(2, 100.0, 60.0), (5, 300.5, 200.9)],
          "border": [(0, 0.0, 0.0), (3, 456.0, 300.0)]}  # the square clipped at the edges


@pytest.mark.parametrize("flip,dilate", [(False, True), (True, True), (False, False),
                                         (True, False)], ids=["dilate", "flip_dilate",
                                                               "sharp", "flip_sharp"])
@pytest.mark.parametrize("points", list(POINTS))
@pytest.mark.parametrize("original", [(480, 640), (301, 457)], ids=["480x640", "301x457"])
def test_rasterize_matches_cv2(original, points, flip, dilate):
    pts = POINTS[points]
    got = rasterize.rasterize_gesture_points(pts, original, TARGET, 6, flip, dilate)
    want = jr.rasterize_gesture_points(pts, original, TARGET, 6, flip, dilate)
    assert got.shape == want.shape == (6,) + TARGET + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_blur_kernel_is_separable():
    g = rasterize.gaussian_1d(99, 10.0)
    np.testing.assert_allclose(np.outer(g, g), jr._BLUR_KERNEL, rtol=0, atol=1e-17)
    np.testing.assert_array_equal(rasterize.bivariate_gaussian(99, 10.0), jr._BLUR_KERNEL)


@pytest.mark.parametrize("shape,out", [((480, 640, 3), (256, 384)), ((100, 80, 3), (256, 384)),
                                       ((7, 9), (30, 20))], ids=["down", "up", "tiny"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resize_bicubic_matches_cv2(shape, out, dtype):
    rng = np.random.RandomState(0)
    img = (rng.rand(*shape) * 255).astype(dtype)
    got = image.resize_bicubic(img, *out)
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_CUBIC)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.uint8:
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)  # 0-255 scale


def _instance(path, kind, hw=(301, 457)):
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(1)
    rgb = cv2.GaussianBlur((rng.rand(*hw, 3) * 255).astype(np.uint8), (7, 7), 2)
    f = os.path.join(path, "im_0.jpg")
    if kind == "jpeg":
        cv2.imwrite(f, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    elif kind == "progressive_jpeg":
        Image.fromarray(rgb).save(f, format="JPEG", progressive=True)
    elif kind == "png_cv2":  # PNG bytes under the .jpg name, libpng's row filters
        cv2.imwrite(os.path.join(path, "x.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        os.replace(os.path.join(path, "x.png"), f)
    else:
        video_io.write_png(f, rgb)
    with open(os.path.join(path, "data.txt"), "w") as fh:
        fh.write("0 120 80\n\n9 300.5 200\n")
    return str(path)


@pytest.mark.parametrize("kind", ["jpeg", "progressive_jpeg", "png_cv2", "png_port"])
def test_image_size_from_header(tmp_path, kind):
    inst = _instance(tmp_path / kind, kind, (301, 457))
    assert image.image_size(os.path.join(inst, "im_0.jpg")) == (301, 457)


@pytest.mark.parametrize("kind", ["jpeg", "progressive_jpeg", "png_cv2", "png_port"])
def test_load_condition_matches_jax(tmp_path, kind):
    inst = _instance(tmp_path / kind, kind)
    got = rasterize.load_condition(inst, (64, 128), 14)
    want = jr.load_condition(inst, (64, 128), 14)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert got[1:] == want[1:] == (200, [0, 9], [(80.0, 120.0), (200.0, 300.5)])


@pytest.mark.parametrize("kind", ["jpeg", "progressive_jpeg", "png_cv2", "png_port"])
def test_instance_image_matches_jax(tmp_path, kind):
    inst = _instance(tmp_path / kind, kind)
    got = _load_instance_image(inst, 256, 384)
    want = jax_instance_image(inst, 256, 384)
    assert got.shape == want.shape == (256, 384, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1 / 127.5 + 1e-6
