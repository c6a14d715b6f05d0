"""The port's gradio UI (``app.launch_gradio``) and the four tools of
``utils/video_io.py`` ported last, held to the JAX package: the UI through
the stubbed ``gradio`` module of ``tests/test_app_gradio.py`` (upload,
point select, clear and run handlers; tiny random weights, 2 steps; an mp4
or its GIF stand-in lands), the tools against the JAX functions on the same
inputs as ``tests/test_tools.py`` drives them."""

import os
import sys

import numpy as np
import pytest

from this_and_that_vdm_tpu.utils import video_io as jvio
from this_and_that_vdm_tpu_torch import app
from this_and_that_vdm_tpu_torch.utils import video_io

from test_app_gradio import _make_gradio_stub
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


def test_gradio_ui_wiring_end_to_end(monkeypatch, tmp_path):
    registry = []
    stub = _make_gradio_stub(registry)
    monkeypatch.setitem(sys.modules, "gradio", stub)
    monkeypatch.setattr(app, "HEIGHT", 64)
    monkeypatch.setattr(app, "WIDTH", 128)
    monkeypatch.setattr(app, "FRAMES", 2)
    monkeypatch.setattr(app, "GESTURE_FRAME_IDXS", [0, 1])
    monkeypatch.setattr(app, "SAMPLING_DEFAULTS", dict(
        motion_bucket_id=200, noise_aug_strength=0.1, decode_chunk_size=2,
        output_type="uint8"))
    monkeypatch.setattr(app.tempfile, "tempdir", str(tmp_path))
    server = app.launch_gradio(random_weights=True, dtype="f32", device="cpu")
    try:
        events = {e: fn for e, fn, _, _ in registry}
        assert set(events) >= {"upload", "select", "click"}
        clicks = [r for r in registry if r[0] == "click"]
        assert len(clicks) == 2  # clear, then run

        img = np.random.RandomState(0).randint(0, 255, (120, 160, 3), np.uint8)
        shown, orig, points = events["upload"](img)
        assert points == [] and orig is img
        vis, points = events["select"](orig, points, stub.SelectData((40, 30)))
        vis, points = events["select"](orig, points, stub.SelectData((90, 70)))
        vis, points = events["select"](orig, points, stub.SelectData((10, 10)))  # capped
        assert points == [(40, 30), (90, 70)] and vis.shape == img.shape
        assert (vis[30, 40] == (255, 0, 0)).all() and (vis[70, 90] == (0, 255, 0)).all()
        assert (img[30, 40] != vis[30, 40]).any()  # drawn on a copy
        _, cleared = clicks[0][1](orig)
        assert cleared == []

        run = clicks[1][1]
        out = run(orig, points, "put this to there", 1, 2)
        assert os.path.exists(out) and os.path.getsize(out) > 0
        assert out.startswith(str(tmp_path))
        with pytest.raises(RuntimeError):
            run(None, points, "p", 1, 2)
        with pytest.raises(RuntimeError):
            run(orig, [], "p", 1, 2)
    finally:
        server.close(timeout=30.0)


def _method_dirs(tmp_path, heights):
    rng = np.random.RandomState(0)
    dirs = []
    for m, h in enumerate(heights):
        d = tmp_path / f"m{m}"
        os.makedirs(d)
        for i in range(3):
            video_io.write_png(str(d / f"{i}.png"), rng.randint(0, 255, (h, 24, 3), np.uint8))
        dirs.append(str(d))
    return dirs


@pytest.mark.parametrize("heights,labels", [((16, 16), ["a", "b"]), ((16, 24), None),
                                            ((16, 16), None)],
                         ids=["labels", "resize", "plain"])
def test_combine_results_grid_matches_jax(tmp_path, monkeypatch, heights, labels):
    dirs = _method_dirs(tmp_path, heights)
    rows = {}
    for name, mod in (("jax", jvio), ("port", video_io)):
        monkeypatch.setattr(mod, "export_gif",
                            lambda frames, path, fps=4, name=name: rows.setdefault(name, frames)
                            and path)
        out = mod.combine_results_grid(dirs, str(tmp_path / f"{name}.gif"), labels=labels)
        assert out == str(tmp_path / f"{name}.gif")
    assert len(rows["port"]) == len(rows["jax"]) == 3
    for got, want in zip(rows["port"], rows["jax"]):
        np.testing.assert_array_equal(got, want)


def test_combine_results_grid_needs_cv2_only_for_labels_and_resizing(tmp_path, monkeypatch):
    dirs = _method_dirs(tmp_path, (16, 16))
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = video_io.combine_results_grid(dirs, str(tmp_path / "grid.gif"))
    assert os.path.getsize(out) > 0
    with pytest.raises(RuntimeError, match="cv2"):
        video_io.combine_results_grid(dirs, str(tmp_path / "grid2.gif"), labels=["a", "b"])


@pytest.mark.parametrize("n,target", [(5, 14), (3, 7), (14, 14), (1, 4), (4, 25)])
def test_repeat_to_length_matches_jax(n, target):
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(n)]
    got = [int(f[0, 0, 0]) for f in video_io.repeat_to_length(frames, target)]
    assert got == [int(f[0, 0, 0]) for f in jvio.repeat_to_length(frames, target)]
    assert len(got) == target


def test_interpolate_by_repeat_matches_jax():
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(3)]
    for factor in (1, 2, 3):
        got = video_io.interpolate_by_repeat(frames, factor)
        want = jvio.interpolate_by_repeat(frames, factor)
        assert [int(f[0, 0, 0]) for f in got] == [int(f[0, 0, 0]) for f in want]


def test_train_test_split_matches_jax(tmp_path):
    for i in range(10):
        os.makedirs(tmp_path / f"{i:06d}")
    (tmp_path / "notes.txt").write_text("not an instance")
    for frac, seed in ((0.2, 42), (0.5, 7), (0.0, 1)):
        got = video_io.train_test_split(str(tmp_path), frac, seed)
        assert got == jvio.train_test_split(str(tmp_path), frac, seed)
        assert not set(got[0]) & set(got[1]) and len(got[0]) + len(got[1]) == 10
