"""The port's tracking facade, painters and curation tools
(``curation/tracking.py``, ``painters.py``, ``tools.py``) against the JAX
modules, on the CPU, where cv2 (which the JAX modules call) is installed.

  * the template propagator and ``track_by_keypoint`` with it: masks and
    ``mask_N.png`` files equal to the JAX ones (cv2's ``matchTemplate``);
  * ``XMemPropagator`` from a ``.pth`` file and ``TrackingAnything`` (SAM
    faked, a non-contiguous label) against the JAX facades on the same
    weights: masks by IoU >= 0.99 (``tests/test_torch_xmem.py`` holds the
    probabilities themselves to 1e-4);
  * the painters pixel for pixel; the contour band against cv2's
    ``findContours`` + ``drawContours``: 0 pixels differ on the test masks
    (a rectangle, a disc, a ring with an island, a mask at the border,
    random noise, a notched square, a slanted band);
  * the tools: the same files and results; ``resize_video_seq`` within one
    uint8 level of cv2's bicubic;
  * without ``device="cpu"`` every entry point wants the card.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from this_and_that_vdm_tpu.curation import painters as jpaint
from this_and_that_vdm_tpu.curation import tools as jtools
from this_and_that_vdm_tpu.curation import tracking as jtrack

from this_and_that_vdm_tpu_torch.curation import painters, tools, tracking
from this_and_that_vdm_tpu_torch.models import xmem as xm
from this_and_that_vdm_tpu_torch.utils.video_io import read_png, write_png

from test_torch_xmem import seeded_state_dict
from torch_one_thread import one_torch_thread  # noqa: F401


def moving_square_clip(n=5, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
    tex = rng.randint(120, 255, (16, 16, 3)).astype(np.uint8)
    frames = []
    for i in range(n):
        f = bg.copy()
        f[24 + i:40 + i, 16 + 4 * i:32 + 4 * i] = tex
        frames.append(f)
    mask = np.zeros((h, w), bool)
    mask[24:40, 16:32] = True
    mask[24, 16] = False  # a shape, not only a box
    return frames, mask


def test_template_propagator_matches_jax():
    frames, mask = moving_square_clip()
    got = tracking.template_mask_propagator(frames, mask, device="cpu")
    want = jtrack.template_mask_propagator(frames, mask)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == bool and np.array_equal(g, w)
    assert got[-1][40, 40]  # it followed the square
    empty = np.zeros_like(mask)
    assert all(not m.any() for m in tracking.template_mask_propagator(frames, empty, "cpu"))


class FakeSegmenter:
    """A fixed square mask wherever the click lands; records the BGR frame."""

    def predict_mask(self, image_bgr, points_xy, box_xyxy=None):
        self.seen = (np.asarray(image_bgr).copy(), np.asarray(points_xy))
        m = np.zeros(image_bgr.shape[:2], bool)
        m[24:40, 16:32] = True
        return m


def instance(root, frames):
    os.makedirs(root)
    for i, f in enumerate(frames):
        write_png(os.path.join(root, f"im_{i}.jpg"), f)  # PNG bytes under the .jpg name
    with open(os.path.join(root, "data.txt"), "w") as f:
        f.write("0 24.0 30.0\n3 50.0 30.0\n")
    return root


def test_track_by_keypoint_matches_jax(tmp_path):
    frames, _ = moving_square_clip()
    src = instance(str(tmp_path / "inst"), frames)
    a, b = FakeSegmenter(), FakeSegmenter()
    got = tracking.track_by_keypoint(src, a, store_dir=str(tmp_path / "port"), device="cpu")
    want = jtrack.track_by_keypoint(src, b, store_dir=str(tmp_path / "jax"))
    assert np.array_equal(a.seen[0], b.seen[0]) and np.array_equal(a.seen[1], b.seen[1])
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w)
        mine = read_png(str(tmp_path / "port" / f"mask_{i}.png"))
        assert np.array_equal(mine[..., 0], cv2.imread(str(tmp_path / "jax" / f"mask_{i}.png"),
                                                       cv2.IMREAD_GRAYSCALE))


@pytest.fixture(scope="module")
def xmem_file(tmp_path_factory):
    with torch.device("meta"):
        names = xm.XMem()
    sd = seeded_state_dict(names, seed=4)
    path = str(tmp_path_factory.mktemp("xmem") / "XMem-s012.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def iou(a, b):
    union = np.logical_or(a, b).sum()
    return np.logical_and(a, b).sum() / union if union else 1.0


def test_xmem_propagator_matches_jax(xmem_file):
    frames, mask = moving_square_clip(n=7, h=48, w=64)
    got = tracking.XMemPropagator(xmem_file, device="cpu")(frames, mask)
    want = jtrack.XMemPropagator(xmem_file)(frames, mask)
    assert len(got) == len(want) == 7 and np.array_equal(got[0], mask)
    assert all(g.dtype == bool and g.shape == mask.shape for g in got)
    assert min(iou(g, w) for g, w in zip(got, want)) >= 0.99


def test_tracking_anything_matches_jax(xmem_file):
    """A click, then a template with the non-contiguous label 7 tracked over
    three frames: indexed masks in the caller's labels, painted frames."""
    from this_and_that_vdm_tpu.weights.convert import xmem_state_dict_to_flax

    frames, _ = moving_square_clip(n=3, h=48, w=64)
    port = tracking.TrackingAnything(FakeSegmenter(), tracking.load_xmem(xmem_file, "cpu"),
                                     device="cpu")
    sd = {k: v.numpy() for k, v in torch.load(xmem_file, weights_only=True).items()}
    ref = jtrack.TrackingAnything(FakeSegmenter(), jax.tree.map(jnp.asarray,
                                                                xmem_state_dict_to_flax(sd)))
    click = np.array([[24, 30]])
    (m, _, p), (jm, _, jp) = (t.first_frame_click(frames[0], click) for t in (port, ref))
    assert np.array_equal(m, jm) and np.array_equal(p, jp)
    template = np.zeros(m.shape, np.uint8)
    template[m] = 7
    (masks, _, painted), (jmasks, _, jpainted) = (t.generator(frames, template)
                                                  for t in (port, ref))
    for g, w in zip(masks, jmasks):
        assert g.dtype == np.uint8 and set(np.unique(g)) <= {0, 7}
        assert iou(g == 7, w == 7) >= 0.99
    assert np.array_equal(painted[0], jpainted[0])
    assert all(pp.shape == frames[0].shape for pp in painted)


# ------------------------------------------------------------------ painters


def contour_masks():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :48]
    m = np.zeros((64, 48), bool)
    m[10:30, 8:25] = True
    yield m
    yield (yy - 30) ** 2 + (xx - 20) ** 2 < 15 ** 2
    m = np.zeros((64, 48), bool)
    m[5:50, 5:40], m[15:30, 15:25], m[18:25, 18:22] = True, False, True
    yield m
    m = np.zeros((64, 48), bool)
    m[0:20, :] = True
    yield m
    yield rng.random((64, 48)) > 0.6
    m = np.zeros((64, 48), bool)
    m[10:40, 10:40], m[20:30, 25:40] = True, False
    yield m
    yield np.abs(yy - 32 + 0.7 * (xx - 24)) < 8


def test_contour_band_equals_cv2():
    differing = [int((painters.mask_contour(m) != jpaint.mask_contour(m)).sum())
                 for m in contour_masks()]
    assert differing == [0] * 7, differing


@pytest.mark.parametrize("width", [1, 2, 3, 7])
def test_contour_band_equals_cv2_at_widths_and_on_frame_noise(width):
    """cv2's border following and thick outline, pixel for pixel, on the
    test masks and on 480x640 masks of noise (thousands of contours, many at
    the frame's edge, where cv2 clips the quads' outlines)."""
    rng = np.random.default_rng(width)
    masks = list(contour_masks()) + [rng.random((480, 640)) > t for t in (0.4, 0.7)]
    differing = [int((painters.mask_contour(m, width) != jpaint.mask_contour(m, width)).sum())
                 for m in masks]
    assert differing == [0] * len(masks), differing


def test_painters_match_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    masks = list(contour_masks())
    for i in range(25):
        assert painters.colormap(i) == jpaint.colormap(i)
    for m in masks:
        assert np.array_equal(painters.vis_add_mask(img, m, 3, 0.6),
                              jpaint.vis_add_mask(img, m, 3, 0.6))
        assert np.array_equal(painters.mask_painter(img, m), jpaint.mask_painter(img, m))
    pts = [(10, 12), (40.7, 3.2), (-5, 30), (47, 63), (24, 70)]  # some off the frame
    for r in (0, 1, 4, 15):
        assert np.array_equal(painters.point_painter(img, pts, point_radius=r),
                              jpaint.point_painter(img, pts, point_radius=r))
    index = np.zeros((64, 48), np.uint8)
    index[masks[0]], index[masks[6]] = 2, 5
    assert np.array_equal(painters.multi_mask_painter(img, index),
                          jpaint.multi_mask_painter(img, index))
    assert np.array_equal(painters.sam_visualization(img, masks[1], pts),
                          jpaint.sam_visualization(img, masks[1], pts))
    assert np.array_equal(painters.make_colorwheel(), jpaint.make_colorwheel())
    flow = rng.standard_normal((32, 40, 2)).astype(np.float32) * 5
    for kw in ({}, {"clip_flow": 3.0}, {"convert_to_bgr": True}):
        assert np.array_equal(painters.flow_to_image(flow, **kw), jpaint.flow_to_image(flow, **kw))


# --------------------------------------------------------------------- tools


def same_tree(a, b):
    """The same files: images pixel for pixel, everything else byte for byte."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            same_tree(pa, pb)
        elif name.endswith((".png", ".jpg")):
            assert np.array_equal(read_png(pa), cv2.imread(pb)[..., ::-1]), pa
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa


def test_tools_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (16, 16, 3)).astype(np.uint8) for _ in range(3)]
    for name, mutate in (("flat", False), ("good", False), ("bad", True)):
        os.makedirs(tmp_path / name)
        for i, im in enumerate(imgs):
            im = im.copy()
            if mutate and i == 2:
                im[0, 0] = 255 - im[0, 0]
            write_png(str(tmp_path / name / f"im_{i}.jpg"), im)
    cands = [str(tmp_path / "bad"), str(tmp_path / "good")]
    for n in (2, 3):
        assert (tools.match_instance(str(tmp_path / "flat"), cands, n)
                == jtools.match_instance(str(tmp_path / "flat"), cands, n))
    assert tools.match_instance(str(tmp_path / "flat"), cands, 3).endswith("good")
    assert np.array_equal(tools.visualize_points(imgs[0], [(3, 4), (12, 9), (8, 8)], 3),
                          jtools.visualize_points(imgs[0], [(3, 4), (12, 9), (8, 8)], 3))

    root = tmp_path / "inst"
    for name, n, lang in (("a", 14, True), ("b", 5, True), ("c", 14, False), ("d", 15, True)):
        os.makedirs(root / name)
        for i in range(n):
            write_png(str(root / name / f"im_{i}.jpg"), imgs[i % 3])
        if lang:
            (root / name / "lang.txt").write_text(f"prompt {name}\nmore\n")
    assert tools.collect_lang(str(root)) == jtools.collect_lang(str(root))
    assert tools.length_stats(str(root)) == jtools.length_stats(str(root))
    p = tools.ingest_llama_decomposition(str(root / "a"), "put", "the fork", "the plate")
    assert open(p).read() == "put\nthe fork\nthe plate\n"
    import shutil
    shutil.copytree(root, tmp_path / "inst_j")
    removed = tools.clean_dataset(str(root))
    jremoved = jtools.clean_dataset(str(tmp_path / "inst_j"))
    assert [os.path.basename(r) for r in removed] == [os.path.basename(r) for r in jremoved]
    assert tools.length_stats(str(root)) == jtools.length_stats(str(tmp_path / "inst_j"))

    vids = tmp_path / "vids"
    for v in ("v0", "v1"):
        os.makedirs(vids / v)
        for i in range(3):
            write_png(str(vids / v / f"{i}.png"), rng.randint(0, 255, (40, 52, 3)).astype(
                np.uint8))
    assert (tools.resize_video_seq(str(vids), str(tmp_path / "rs"), (24, 30))
            == jtools.resize_video_seq(str(vids), str(tmp_path / "rs_j"), (24, 30)) == 6)
    for v in ("v0", "v1"):
        for i in range(3):
            got = read_png(str(tmp_path / "rs" / v / f"{i}.png")).astype(int)
            want = cv2.imread(str(tmp_path / "rs_j" / v / f"{i}.png"))[..., ::-1].astype(int)
            assert got.shape == (24, 30, 3) and np.abs(got - want).max() <= 1
    shutil.copytree(vids, tmp_path / "vids_j")
    assert (tools.truncate_video_frames(str(vids), 2)
            == jtools.truncate_video_frames(str(tmp_path / "vids_j"), 2) == 2)
    same_tree(str(vids), str(tmp_path / "vids_j"))
    (tmp_path / "match.txt").write_text("a /data/x/1\nb /data/x/2\nlonely\n")
    for mod, out in ((tools, "e.txt"), (jtools, "e_j.txt")):
        assert mod.extract_test_paths(str(tmp_path / "match.txt"), str(tmp_path / out),
                                      "/data/") == 2
    assert (tmp_path / "e.txt").read_text() == (tmp_path / "e_j.txt").read_text()
    tools.generate_noise_images(str(tmp_path / "noise"), 2, (8, 10), seed=3)
    jtools.generate_noise_images(str(tmp_path / "noise_j"), 2, (8, 10), seed=3)
    for i in range(2):  # the JAX tool writes the RGB array through cv2 (as BGR)
        assert np.array_equal(read_png(str(tmp_path / "noise" / f"noise{i}.png")),
                              cv2.imread(str(tmp_path / "noise_j" / f"noise{i}.png")))
    assert (tools.active_learning_select(str(vids / "v0"), str(tmp_path / "al"), 1)
            == jtools.active_learning_select(str(vids / "v0"), str(tmp_path / "al_j"), 1) == 1)
    same_tree(str(tmp_path / "al"), str(tmp_path / "al_j"))


def test_process_sim_dataset_matches_jax(tmp_path):
    sim = tmp_path / "sim"
    for r in range(20):
        d = sim / f"run_{r}"
        os.makedirs(d)
        (d / "frame.bin").write_bytes(bytes([r]) * 4)
        if r not in (3, 14):  # prompts compact over missing files
            (d / "lang.txt").write_text(f"prompt {r}\n")
    assert (tools.process_sim_dataset(str(sim), str(tmp_path / "out"), 10, 6)
            == jtools.process_sim_dataset(str(sim), str(tmp_path / "out_j"), 10, 6) == 2)
    same_tree(str(tmp_path / "out"), str(tmp_path / "out_j"))


def test_check_videos_needs_cv2(tmp_path, monkeypatch):
    (tmp_path / "broken.mp4").write_bytes(b"not a video")
    assert tools.check_videos(str(tmp_path)) == jtools.check_videos(str(tmp_path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        tools.check_videos(str(tmp_path))


def test_the_card_is_the_default(xmem_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    frames, mask = moving_square_clip(n=2)
    src = instance(str(tmp_path / "inst"), frames)
    for call in (lambda: tracking.XMemPropagator(xmem_file),
                 lambda: tracking.load_xmem(xmem_file),
                 lambda: tracking.TrackingAnything(FakeSegmenter(), xm.XMem()),
                 lambda: tracking.template_mask_propagator(frames, mask),
                 lambda: tracking.track_by_keypoint(src, FakeSegmenter())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
