"""The port's native frame loader (``csrc/ttv_loader.cpp`` through
``data/native_loader.py``; the host library built here with the host
compiler), on the CPU.

- float32 and uint8 outputs, with and without flip, and for 1, 3 and 8
  threads: bit-equal to the port's plain ``bridge.load_frames_plain``
  (``read_image`` + numpy ``resize_bicubic``) on a tree of JPEG and
  PNG-bytes frames.
- The port's ``bridge.load_frames`` (the native loader) within 1/127.5 of
  the JAX ``bridge.load_frames`` on the same JPEG tree, through the JAX
  native loader and through its cv2 path; the share of values that differ
  is printed (IPP's bicubic inside cv2.resize against the port's float64
  one: 0-1% of levels, one level at most).
- The port's resize tool writes the bytes the JAX tool writes for each
  ``.jpg`` (JPEG, where it wrote PNG bytes before) and the same pixels for a
  ``.png`` within one level: the float64 bicubic and the IPP one inside
  cv2.resize part at rare pixels (one of 4,608 values of the noisy PNG
  here), and a frame with such a pixel gets other JPEG bytes.
- A frame that cannot be read raises with its path (the first failing one);
  a missing compiler or a failed build raises with the compiler's output;
  the library's name follows its sources and its compiler.
"""

import os
import shutil

import cv2
import numpy as np
import pytest

import make_jpeg_goldens as goldens
from this_and_that_vdm_tpu.curation import tools as jtools
from this_and_that_vdm_tpu.data import bridge as jbridge
from this_and_that_vdm_tpu.data import native_loader as jnative_loader

from this_and_that_vdm_tpu_torch.curation import tools
from this_and_that_vdm_tpu_torch.data import bridge, native_loader
from this_and_that_vdm_tpu_torch.utils import host_native, video_io

N, ORIG, HW = 6, (60, 80), (32, 48)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames 0..5 of one instance: JPEG written by the port (as cv2 writes
    them) and, at 2 and 5, PNG bytes under the .jpg names."""
    d = str(tmp_path_factory.mktemp("inst"))
    for i in range(N):
        img = goldens.source_image(40 + i, *ORIG)
        path = os.path.join(d, f"im_{i}.jpg")
        (video_io.write_png if i in (2, 5) else video_io.write_jpeg)(path, img)
    return d


def _paths(d):
    return [os.path.join(d, f"im_{i}.jpg") for i in range(N)]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_native_equals_plain(tree, flip, normalized):
    got = bridge.load_frames(tree, range(N), HW, flip, normalized)
    want = bridge.load_frames_plain(tree, range(N), HW, flip, normalized)
    assert got.shape == (N,) + HW + (3,) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [False, True])
def test_native_u8_equals_plain(tree, flip):
    got = native_loader.load_frames_native_u8(_paths(tree), HW, flip)
    want = bridge.load_frames_plain(tree, range(N), HW, flip)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.astype(np.float32), want)


def test_thread_count_does_not_change_the_frames(tree):
    outs = [native_loader.load_frames_native(_paths(tree), HW, True, num_threads=t)
            for t in (1, 3, 8)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("jax_path", ["native", "cv2"])
def test_load_frames_within_one_level_of_jax(tmp_path, monkeypatch, jax_path):
    if jax_path == "cv2":
        monkeypatch.setattr(jnative_loader, "available", lambda: False)
    elif not jnative_loader.available():
        pytest.skip("the JAX package's native loader (native/libttv_loader.so) is not built")
    for i in range(N):
        video_io.write_jpeg(str(tmp_path / f"im_{i}.jpg"), goldens.source_image(50 + i, *ORIG))
    for flip in (False, True):
        got = bridge.load_frames(str(tmp_path), range(N), HW, flip, normalized=True)
        want = jbridge.load_frames(str(tmp_path), range(N), HW, flip, normalized=True)
        # as uint8 levels: the JAX native loader scales in another float
        # order, so equal levels may differ in the last ulp
        levels = np.abs(np.round((got + 1) * 127.5) - np.round((want + 1) * 127.5))
        print(f"JAX {jax_path} path, flip {flip}: share of levels that differ "
              f"{np.mean(levels > 0):.6f}, max |diff| {np.abs(got - want).max() * 127.5:.4f}")
        assert np.abs(got - want).max() <= (1 / 127.5) * 1.0001 and np.mean(levels > 0) < 0.05


def test_resize_tool_writes_the_jax_tools_bytes(tmp_path):
    for v in ("v0", "v1"):
        os.makedirs(tmp_path / "src" / v)
        for i in range(2):
            img = goldens.source_image(60 + 2 * int(v[1]) + i, *ORIG)
            cv2.imwrite(str(tmp_path / "src" / v / f"im_{i}.jpg"), img[..., ::-1])
        video_io.write_png(str(tmp_path / "src" / v / "mask.png"), img)
    assert (tools.resize_video_seq(str(tmp_path / "src"), str(tmp_path / "a"), HW)
            == jtools.resize_video_seq(str(tmp_path / "src"), str(tmp_path / "b"), HW) == 6)
    for v in ("v0", "v1"):
        for name in ("im_0.jpg", "im_1.jpg"):
            got = (tmp_path / "a" / v / name).read_bytes()
            assert got[:2] == b"\xff\xd8" and got == (tmp_path / "b" / v / name).read_bytes()
        got = video_io.read_png(str(tmp_path / "a" / v / "mask.png")).astype(int)
        want = cv2.imread(str(tmp_path / "b" / v / "mask.png"))[..., ::-1].astype(int)
        assert np.abs(got - want).max() <= 1  # PNG bytes are zlib's: compare the pixels


def test_unreadable_frames_raise_with_the_first_path(tree, tmp_path):
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    arith = str(tmp_path / "arith.jpg")  # an arithmetic-coded frame header
    with open(arith, "wb") as f:
        f.write(goldens.refused_file(70, *ORIG, 0xC9))
    paths = _paths(tree)
    with pytest.raises(ValueError, match="bad.jpg: neither PNG nor JPEG"):
        native_loader.load_frames_native(paths[:2] + [bad, arith], HW)
    with pytest.raises(ValueError, match="arith.jpg: arithmetic-coded sequential .SOF9."):
        native_loader.load_frames_native(paths[:2] + [arith, bad], HW, num_threads=1)
    with pytest.raises(FileNotFoundError, match="absent.jpg"):
        native_loader.load_frames_native_u8([str(tmp_path / "absent.jpg")] + paths, HW)


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    cxx = host_native._compiler()
    shutil.copytree(host_native.LIB.csrc, tmp_path / "csrc")
    before = host_native.LIB.digest(cxx)
    monkeypatch.setattr(host_native.LIB, "csrc", tmp_path / "csrc")
    assert host_native.LIB.digest(cxx) == before
    with open(tmp_path / "csrc" / "ttv_loader.cpp", "a") as f:
        f.write("\n// edited\n")
    assert host_native.LIB.digest(cxx) != before
    assert host_native.library_path() is None or before in host_native.library_path().name


def test_library_name_follows_the_compiler(tmp_path):
    """A library built by another compiler (on another machine, copied with
    the tree) is not loaded: the compiler's path and version name it too."""
    cxx = host_native._compiler()
    other = tmp_path / "c++"
    other.write_text(f'#!/bin/sh\n[ "$1" = --version ] && echo "other 1.0" && exit 0\n'
                     f'exec {cxx} "$@"\n')
    other.chmod(0o755)
    assert host_native.LIB.digest(str(other)) != host_native.LIB.digest(cxx)


def test_build_failures_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(host_native.LIB, "lib", None)
    monkeypatch.setattr(host_native.LIB, "build_dir", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler.*not found"):
        host_native.library()
    monkeypatch.delenv("CXX")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cpp").write_text("int f() { return undefined_name; }\n")
    monkeypatch.setattr(host_native.LIB, "csrc", tmp_path / "csrc")
    with pytest.raises(RuntimeError, match="(?s)building the host library failed.*undefined_name"):
        host_native.library()
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix in (".so", ".tmp")]
