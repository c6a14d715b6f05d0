"""The port's curation stages (``curation/select_frames.py``,
``trajectory.py``, ``flow_eval.py``) against the JAX ones, on the CPU.

Synthetic Bridge-layout trees (frames as PNG bytes under ``im_N.jpg``,
``policy_out.pkl``, ``lang.txt``) go through both packages' stages, with a
fake detector and with the tiny native models built on one set of weights.
Both must give the same messages and the same files: frames and
``data.txt`` byte for byte, ``mask_0.png`` pixel for pixel,
``traj_data.txt`` byte for byte.  ``flow_eval`` gives the same numbers.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu.curation import detectors as jdet
from this_and_that_vdm_tpu.curation import flow_eval as jflow_eval
from this_and_that_vdm_tpu.curation import select_frames as jselect
from this_and_that_vdm_tpu.curation import trajectory as jtraj
from this_and_that_vdm_tpu.models import raft as jraft
from this_and_that_vdm_tpu.models import yolov8 as jyolo
from this_and_that_vdm_tpu.weights.convert import (raft_state_dict_to_flax,
                                                   sam_state_dict_to_flax,
                                                   yolo_state_dict_to_flax)

from this_and_that_vdm_tpu_torch.curation import detectors, flow_eval, select_frames, trajectory
from this_and_that_vdm_tpu_torch.models import raft, sam, yolov8
from this_and_that_vdm_tpu_torch.models.flowformer import (FlowFormer, FlowFormerConfig,
                                                           save_flowformer)
from this_and_that_vdm_tpu_torch.utils.video_io import read_png, write_png
from this_and_that_vdm_tpu_torch.weights.convert import save_ultralytics_checkpoint

from test_torch_raft import official_state_dict as raft_state_dict
from test_torch_sam import official_state_dict as sam_state_dict
from test_torch_yolo import official_state_dict as yolo_state_dict
from torch_one_thread import one_torch_thread  # noqa: F401

H, W = 48, 64


class FakeDetector:
    """xywh boxes keyed by a frame's marker (its top-left 8x8 block)."""

    def __init__(self, mapping):
        self.mapping = mapping

    def boxes_xywh(self, image_bgr):
        marker = int(round(float(image_bgr[:8, :8, 0].mean()) / 5.0))
        return np.asarray(self.mapping.get(marker, []), np.float32)


BOXES = {5: [[20, 20, 18, 18], [40, 20, 18, 18]], 6: [[20, 20, 18, 18], [30, 22, 18, 18]],
         7: [[20, 20, 18, 18], [45, 20, 18, 18]], 20: [[55, 40, 18, 18]],
         8: [[20, 20, 18, 18]], 19: [[28, 26, 18, 18]]}


def frame(i, seed=0):
    """A textured frame with a block moving (2, 1) px a frame and the marker
    i*5 in its top-left 8x8 block."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(H, W, 3) * 80).astype(np.uint8)
    tex = np.random.RandomState(7).randint(100, 255, (12, 12, 3)).astype(np.uint8)
    x, y = 10 + (2 * i) % 40, 12 + i % 24
    img[y:y + 12, x:x + 12] = tex
    img[:8, :8] = (i * 5) % 256
    return img


def write_instance(root, name, n, start=5, end=20, seed=0, missing=None):
    d = os.path.join(root, name)
    os.makedirs(d)
    for i in range(n):
        if i != missing:
            write_png(os.path.join(d, f"im_{i}.jpg"), frame(i, seed))
    actions = [0.0 if start <= i < end else 1.0 for i in range(n)]
    with open(os.path.join(d, "policy_out.pkl"), "wb") as f:
        pickle.dump([{"actions": np.array([0, 0, 0, 0, 0, 0, a])} for a in actions], f)
    with open(os.path.join(d, "lang.txt"), "w") as f:
        f.write(f"move the block {name}\n")
    return d


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    write_instance(root, "000000", 30)                  # two points
    write_instance(root, "000001", 24, start=8, end=19, seed=1)  # merged points
    write_instance(root, "000002", 60)                  # too long
    write_instance(root, "000003", 10)                  # too short
    write_instance(root, "000004", 30, start=40, end=50)  # no action code
    write_instance(root, "000005", 30, missing=12)      # a frame is missing
    write_instance(root, "000006", 30, start=2)         # nothing at the first contact
    return root


@pytest.fixture(scope="module")
def models():
    """Tiny YOLO, SAM and RAFT of the port, and the JAX wrappers on the same
    weights."""
    ycfg = yolov8.YOLOv8Config.tiny()
    y = yolov8.YOLOv8(ycfg).eval()
    ysd = yolo_state_dict(y, seed=3)
    y.load_state_dict({k: torch.from_numpy(v) for k, v in ysd.items()})
    s = sam.Sam(sam.SamConfig.tiny()).eval()
    ssd = sam_state_dict(s, seed=4)
    s.load_state_dict({k: torch.from_numpy(v) for k, v in ssd.items()})
    r = raft.RAFT(raft.RAFTConfig.tiny()).eval()
    rsd = raft_state_dict(r, seed=5)
    r.load_state_dict({k: torch.from_numpy(v) for k, v in rsd.items()})
    port = dict(yolo=detectors.NativeGripperDetector(model=y, imgsz=64, device="cpu"),
                sam=detectors.NativeSAMSegmenter(model=s, device="cpu"),
                raft=detectors.NativeRAFTFlow(model=r, iters=3, device="cpu"))
    ref = dict(yolo=jdet.NativeGripperDetector(params=yolo_state_dict_to_flax(ysd),
                                               cfg=jyolo.YOLOv8Config.tiny(), imgsz=64),
               sam=jdet.NativeSAMSegmenter(params=sam_state_dict_to_flax(ssd), model_type="tiny"),
               raft=jdet.NativeRAFTFlow(params=raft_state_dict_to_flax(rsd),
                                        cfg=jraft.RAFTConfig.tiny(), iters=3))
    return port, ref


def same_files(a, b):
    """Two output trees hold the same files: PNG masks pixel for pixel (the
    port writes its own PNG), everything else byte for byte."""
    import cv2

    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in sorted(os.listdir(a)):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            same_files(pa, pb)
        elif name.endswith(".png"):
            assert np.array_equal(read_png(pa)[..., ::-1], cv2.imread(pb)), pa
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa


@pytest.mark.parametrize("detector,segmenter", [("fake", None), ("fake", "sam"),
                                                ("yolo", "sam")])
def test_select_frames_dataset_matches_jax(tree, models, tmp_path, detector, segmenter):
    port, ref = models
    det = {"fake": (FakeDetector(BOXES),) * 2, "yolo": (port["yolo"], ref["yolo"])}[detector]
    seg = (port["sam"], ref["sam"]) if segmenter else (None, None)
    got = select_frames.process_dataset(tree, str(tmp_path / "port"), det[0], seg[0])
    want = jselect.process_dataset(tree, str(tmp_path / "jax"), det[1], seg[1])
    assert got == want
    if detector == "fake":
        assert got == {"Success!": 2, "The number of frames is too long": 1,
                       "The number of frames is too short": 1,
                       "We cannot read an action_start or action_end code!": 1,
                       "Invalid error": 1, "Cannot find the first contact point!": 1}
        n = 2 + (segmenter is not None)  # data.txt, lang.txt (+ mask_0.png)
        assert len(os.listdir(tmp_path / "port" / "000000")) == 14 + n
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_select_frames_resample_and_remap_match_jax():
    for n in range(14, 57):
        orders = select_frames.resample_orders(n, 14)
        assert orders == jselect.resample_orders(n, 14) and orders[0] == 1
        assert select_frames.remap_indices([3, n - 2], orders) == jselect.remap_indices(
            [3, n - 2], orders)


def frame_flow(a, b):
    """A deterministic stand-in flow: the block's motion (2, 1) on the block
    pixels of the first frame (textured >= 100, the background < 80)."""
    flow = np.zeros(a.shape[:2] + (2,), np.float32)
    block = (a >= 100).all(-1)
    block[:8, :8] = False  # the marker
    flow[block] = (2.0, 1.0)
    return flow


def curated(root, n=3, frames=14):
    for k in range(n):
        d = os.path.join(root, f"{k:06d}")
        os.makedirs(d)
        for i in range(frames):
            write_png(os.path.join(d, f"im_{i}.jpg"), frame(i, seed=k))
    return root


@pytest.mark.parametrize("flow,segmenter,workers", [("injected", None, 1),
                                                    ("injected", "sam", 2),
                                                    ("raft", "sam", 1)])
def test_trajectory_dataset_matches_jax(models, tmp_path, flow, segmenter, workers):
    port, ref = models
    root = curated(str(tmp_path / "port"))
    shutil.copytree(root, str(tmp_path / "jax"))
    flows = {"injected": (frame_flow,) * 2, "raft": (port["raft"], ref["raft"])}[flow]
    seg = (port["sam"], ref["sam"]) if segmenter else (None, None)
    got = trajectory.process_dataset_traj(root, flow_fn=flows[0], segmenter=seg[0],
                                          num_workers=workers, seed=3)
    want = jtraj.process_dataset_traj(str(tmp_path / "jax"), flow_fn=flows[1],
                                      segmenter=seg[1], num_workers=workers, seed=3)
    assert got == want
    assert got.get("Success!", 0) >= 1, got
    same_files(root, str(tmp_path / "jax"))


def test_trajectory_stages_match_jax():
    frames = np.stack([frame(i) for i in range(8)])
    flows = trajectory.compute_flows(frames, frame_flow)
    np.testing.assert_array_equal(flows, jtraj.compute_flows(frames, frame_flow))
    np.testing.assert_array_equal(trajectory.filter_uv(flows[0]), jtraj.filter_uv(flows[0]))
    start = trajectory.pick_start_point(flows[0])
    assert start == jtraj.pick_start_point(flows[0]) and start is not None
    assert trajectory.chain_trajectory(flows, start) == jtraj.chain_trajectory(flows, start)
    assert trajectory.chain_trajectory_ref(flows, start) == jtraj.chain_trajectory_ref(flows,
                                                                                        start)
    got = trajectory.sample_sam_points(flows[0], 20, 10, np.random.RandomState(1))
    want = jtraj.sample_sam_points(flows[0], 20, 10, np.random.RandomState(1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    vids = [frames, frames[::-1]]
    assert trajectory.dataset_motion_stats(vids, frame_flow) == jtraj.dataset_motion_stats(
        vids, frame_flow)


def test_flow_eval_matches_jax():
    bg = (np.random.RandomState(8).rand(96, 128, 3) * 255).astype(np.uint8)
    clip = flow_eval.make_moving_patch_clip(bg, n_frames=8, velocity=(3.0, 1.0), patch_size=24)
    jclip = jflow_eval.make_moving_patch_clip(bg, n_frames=8, velocity=(3.0, 1.0), patch_size=24)
    for g, w in zip(clip, jclip):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    frames, gt, _ = clip
    gt_fn = lambda a, b, it=iter(gt): next(it)  # noqa: E731
    jgt_fn = lambda a, b, it=iter(gt): next(it)  # noqa: E731
    assert (flow_eval.evaluate_backend_on_clip(frames, gt, (3.0, 1.0), frame_flow)
            == jflow_eval.evaluate_backend_on_clip(frames, gt, (3.0, 1.0), frame_flow))
    assert flow_eval.backend_trajectory(frames, gt_fn) == jflow_eval.backend_trajectory(frames,
                                                                                       jgt_fn)
    assert (flow_eval.epe_sensitivity(gt, epes=(0.5, 1.0), seeds=(0, 1))
            == jflow_eval.epe_sensitivity(gt, epes=(0.5, 1.0), seeds=(0, 1)))
    assert flow_eval.endpoint_error([(1.0, 2.0)], [(4.0, 6.0)]) == 5.0


def test_cli_entry_points_run_on_the_cpu(tree, tmp_path):
    """select_frames.main and trajectory.main with checkpoint files (an
    ultralytics pickle, a SAM state dict, a RAFT file with the ``module.``
    prefix, a FlowFormer ``.npz``) and ``--device cpu``; without it they want
    the card and raise."""
    save_ultralytics_checkpoint(str(tmp_path / "y.pt"),
                                model=yolov8.YOLOv8(yolov8.YOLOv8Config.tiny()))
    torch.save(sam.Sam(sam.SamConfig.tiny()).state_dict(), str(tmp_path / "s.pth"))
    rcfg = raft.RAFTConfig(enc_dims=(8, 8, 12, 16), fdim=16, hdim=16, cdim=16, corr_radius=2,
                           me_c1=24, me_c2=16, me_f1=12, me_f2=8, motion_dim=16, fh_dim=16,
                           mask_dim=16)  # four levels, as from_state_dict assumes
    torch.save({f"module.{k}": v for k, v in raft.RAFT(rcfg).state_dict().items()},
               str(tmp_path / "r.pth"))
    out = str(tmp_path / "out")
    argv = [tree, out, "--yolo", str(tmp_path / "y.pt"), "--sam", str(tmp_path / "s.pth"),
            "--sam-type", "tiny"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            select_frames.main(argv)
    messages = select_frames.main(argv + ["--device", "cpu"])
    assert sum(messages.values()) == 7 and messages["The number of frames is too long"] == 1
    traj_root = curated(str(tmp_path / "curated"), n=2, frames=14)
    for k in range(2):  # 64x64 frames: RAFT's four levels down to 1x1
        for i in range(14):
            write_png(os.path.join(traj_root, f"{k:06d}", f"im_{i}.jpg"),
                      np.tile(frame(i, k), (2, 1, 1))[:64, :64])
    argv = [traj_root, "--raft", str(tmp_path / "r.pth"), "--sam", str(tmp_path / "s.pth"),
            "--sam-type", "tiny", "--device", "cpu"]
    messages = trajectory.main(argv)
    assert sum(messages.values()) == 2
    save_flowformer(str(tmp_path / "f.npz"), FlowFormer(FlowFormerConfig.tiny()))
    argv[1:3] = ["--native-flowformer", str(tmp_path / "f.npz")]
    messages = trajectory.main(argv)
    assert sum(messages.values()) == 2


EXTERNAL = {
    "ultralytics": lambda d: detectors.UltralyticsGripperDetector("y.pt"),
    "segment_anything": lambda d: detectors.SAMSegmenter("s.pth"),
    "flowformer": lambda d: detectors.FlowFormerFlow("f.pth"),
    "select_frames --yolo-backend torch": lambda d: select_frames.main(
        [d, os.path.join(d, "out"), "--yolo", "y.pt", "--yolo-backend", "torch"]),
    "trajectory --flowformer": lambda d: trajectory.main([d, "--flowformer", "f.pth"]),
    "trajectory --sam-backend torch": lambda d: trajectory.main(
        [d, "--sam", "s.pth", "--sam-backend", "torch"]),
}


@pytest.mark.parametrize("name", sorted(EXTERNAL))
def test_external_backends_run_on_the_card_by_default(tmp_path, name):
    """The external-package wrappers take ``device`` (default the card) as
    the native ones do, and the CLIs pass ``--device`` to them: where there
    is no card they raise before their package is imported."""
    if torch.cuda.is_available():  # the card passes; the package is what is missing
        with pytest.raises(ImportError):
            EXTERNAL[name](str(tmp_path))
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            EXTERNAL[name](str(tmp_path))


def test_farneback_raises_clearly_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cv2"):
        detectors.farneback_flow(img, img)
