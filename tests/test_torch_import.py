"""The port stands alone: it imports no JAX, builds nothing at import, its
entry-point modules work without cv2, PIL, imageio, transformers,
safetensors or regex (the card's machine need not have them), and a CPU
tensor takes each kernel's plain version without launching anything."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu_torch import ops
from this_and_that_vdm_tpu_torch.ops import (_native, adam8bit, flash_attention, groupnorm,
                                             ln_matmul)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import this_and_that_vdm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from this_and_that_vdm_tpu_torch.ops import _native
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax",
             "this_and_that_vdm_tpu.")) or m == "this_and_that_vdm_tpu")
print(len(names), bad, _native._lib)
"""


def test_importing_every_module_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout.strip()
    assert out.endswith("[] None"), out  # no jax/flax/JAX package; no kernel library built
    assert int(out.split(" ")[0]) >= 20, out


def test_training_tools_are_among_the_modules_imported():
    """The modules of the training path and its tools are walked (and so
    imported with JAX left out) by the check above."""
    import pkgutil

    import this_and_that_vdm_tpu_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    for name in ("data.bridge", "curation.prepare_bridge", "training.validation",
                 "training.train_loop", "utils.lpips", "utils.profiling", "cli.adam8bit_ab",
                 "app", "models.sam", "models.yolov8", "models.raft", "curation.detectors",
                 "curation.select_frames", "curation.trajectory", "curation.flow_eval",
                 "models.xmem", "models.flowformer", "curation.xmem_tracker",
                 "curation.tracking", "curation.painters", "curation.tools",
                 "training.xmem_trainer"):
        assert f"{pkg.__name__}.{name}" in names, name


# the card-path modules with the optional packages blocked: import fails
# for each of them, as where they are not installed
_WITHOUT_OPTIONAL = """
import os, sys, tempfile
BLOCKED = ("cv2", "PIL", "imageio", "transformers", "safetensors", "regex")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
from this_and_that_vdm_tpu_torch import app
from this_and_that_vdm_tpu_torch.cli import (adam8bit_ab, eval, inference, rehearsal, sweep,
                                             tokenizer)
from this_and_that_vdm_tpu_torch.curation import prepare_bridge
from this_and_that_vdm_tpu_torch.data import bridge, image, rasterize
from this_and_that_vdm_tpu_torch.training import train_loop, validation
from this_and_that_vdm_tpu_torch.utils import lpips, profiling
from this_and_that_vdm_tpu_torch.serving import VideoGenServer
from this_and_that_vdm_tpu_torch.utils import video_io
from this_and_that_vdm_tpu_torch.weights import export, loader, safetensors_io

d = tempfile.mkdtemp()
ts = {"a": torch.randn(3, 5).bfloat16(), "b": torch.arange(7), "e": torch.empty(0, 2),
      "h": torch.randn(4).half()}
safetensors_io.save_file(ts, os.path.join(d, "x.safetensors"), {"k": "v"})
back = safetensors_io.load_file(os.path.join(d, "x.safetensors"))
assert all(torch.equal(back[k], ts[k]) for k in ts)

rehearsal._write_tokenizer(d)
ids = tokenizer.CLIPTokenizer.from_pretrained(d)(["Pick the red block up, it's 2 cm!"])
assert ids.shape == (1, 77) and ids[0, 0] == 0 and 1 in ids[0]

cond = rasterize.rasterize_gesture_points([(0, 30.0, 20.0), (1, 50.0, 40.0)], (48, 64),
                                          (32, 48), 2, flip=True)
assert cond.shape == (2, 32, 48, 3) and np.isfinite(cond).all() and cond.max() <= 1.0 + 1e-6

rgb = (np.arange(16 * 24 * 3) % 256).astype(np.uint8).reshape(16, 24, 3)
inst = os.path.join(d, "inst")
os.makedirs(inst)
video_io.write_png(os.path.join(inst, "im_0.jpg"), rgb)  # PNG bytes under the .jpg name
assert np.array_equal(video_io.read_png(os.path.join(inst, "im_0.jpg")), rgb)
assert image.image_size(os.path.join(inst, "im_0.jpg")) == (16, 24)
img = inference._load_instance_image(inst, 8, 12)
assert img.shape == (8, 12, 3) and -1.0 <= img.min() and img.max() <= 1.0
video_io.export_gif([rgb, rgb[::-1]], os.path.join(d, "a.gif"))

with open(os.path.join(d, "fake.jpg"), "wb") as f:
    f.write(bytes([0xFF, 0xD8, 0xFF, 0xE0]) + bytes(16))
try:
    video_io.read_image(os.path.join(d, "fake.jpg"))
    raise AssertionError("a JPEG was read with no decoder")
except RuntimeError as e:
    assert "cv2" in str(e) and "PIL" in str(e), e
# a Bridge instance of PNG-bytes frames through the datasets and the loader
for k in range(2):
    ik = os.path.join(d, "data", f"i{k}")
    os.makedirs(ik)
    for i in range(3):
        video_io.write_png(os.path.join(ik, f"im_{i}.jpg"), rgb)
    with open(os.path.join(ik, "lang.txt"), "w") as f:
        f.write("push the cup\\n")
    with open(os.path.join(ik, "data.txt"), "w") as f:
        f.write("0 5.0 4.0\\n")
cfg = bridge.DataConfig(dataset_path=[os.path.join(d, "data")], video_seq_length=3, height=8,
                        width=12)
ds = bridge.VideoThisThatDataset(cfg, lambda s: tokenizer.hash_tokenizer()(s)[0])
batch = next(iter(bridge.PrefetchLoader(ds, 2, num_workers=2)))
assert batch["video_frames"].shape == (2, 3, 8, 12, 3) and batch["condition"].shape[0] == 2
# the clip writer falls back to a GIF without imageio
assert video_io.export_mp4([rgb, rgb], os.path.join(d, "c.mp4")).endswith("c.gif")
m = lpips.LPIPS()
assert m(torch.zeros(1, 35, 35, 3), torch.zeros(1, 35, 35, 3)).shape == (1,)
assert profiling.device_memory_stats("cpu") == {}
bad = sorted(m for m in sys.modules if m in ("jax", "this_and_that_vdm_tpu")
             or (m.split(".")[0] in BLOCKED and sys.modules[m] is not None))
print("ok", bad)
"""


def test_entry_points_work_without_optional_packages():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _WITHOUT_OPTIONAL], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok []", res.stdout


# the curation path with cv2, PIL and the perception packages blocked: the
# models, the PIL-free and cv2-free resizes, the PNG mask and both stages;
# only farneback_flow needs cv2, and only when it is called
_CURATION_WITHOUT_OPTIONAL = """
import os, pickle, sys, tempfile
BLOCKED = ("cv2", "PIL", "ultralytics", "segment_anything", "imageio", "transformers")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
from this_and_that_vdm_tpu_torch.curation import (detectors, flow_eval, select_frames,
                                                  trajectory)
from this_and_that_vdm_tpu_torch.models import raft, sam, yolov8
from this_and_that_vdm_tpu_torch.utils import video_io

img = (np.arange(30 * 50 * 3) % 251).astype(np.uint8).reshape(30, 50, 3)
seg = detectors.NativeSAMSegmenter(model=sam.Sam(sam.SamConfig.tiny()), device="cpu")
det = detectors.NativeGripperDetector(model=yolov8.YOLOv8(yolov8.YOLOv8Config.tiny()),
                                      imgsz=64, device="cpu")
flow = detectors.NativeRAFTFlow(model=raft.RAFT(raft.RAFTConfig.tiny()), iters=2, device="cpu")
assert seg.predict_mask(img, [[10.0, 12.0]], [2.0, 3.0, 30.0, 20.0]).shape == (30, 50)
assert det.boxes_xywh(img).shape[1] == 4  # a letterbox that resizes (64 / 50)
assert flow(img, img[::-1].copy()).shape == (30, 50, 2)
try:
    detectors.farneback_flow(img, img)
    raise AssertionError("Farneback ran with no cv2")
except RuntimeError as e:
    assert "cv2" in str(e), e

d = tempfile.mkdtemp()
src = os.path.join(d, "raw", "000000")
os.makedirs(src)
for i in range(20):
    video_io.write_png(os.path.join(src, f"im_{i}.jpg"), np.full((30, 50, 3), i * 5, np.uint8))
with open(os.path.join(src, "policy_out.pkl"), "wb") as f:
    pickle.dump([{"actions": np.array([0.0 if 3 <= i < 15 else 1.0])} for i in range(20)], f)
with open(os.path.join(src, "lang.txt"), "w") as f:
    f.write("push the cup\\n")

class Boxes:
    def boxes_xywh(self, image_bgr):
        return np.array([[20.0, 14.0, 18.0, 18.0]], np.float32)

msgs = select_frames.process_dataset(os.path.join(d, "raw"), os.path.join(d, "out"), Boxes(), seg)
assert msgs == {"Success!": 1}, msgs
out = os.path.join(d, "out", "000000")
assert video_io.read_png(os.path.join(out, "mask_0.png")).shape == (30, 50, 3)
msgs = trajectory.process_dataset_traj(os.path.join(d, "out"), flow_fn=flow, segmenter=seg)
assert sum(msgs.values()) == 1, msgs
bg = np.zeros((64, 64, 3), np.uint8)
frames, gt, _ = flow_eval.make_moving_patch_clip(bg, n_frames=4, patch_size=16,
                                                 start_rc=(10, 10))
assert frames.shape == (4, 64, 64, 3)
bad = sorted(m for m in sys.modules if m in ("jax", "this_and_that_vdm_tpu")
             or (m.split(".")[0] in BLOCKED and sys.modules[m] is not None))
print("ok", bad)
"""


def test_curation_path_works_without_optional_packages():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CURATION_WITHOUT_OPTIONAL], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok []", res.stdout


# tracking, FlowFormer, the painters, the tools and the XMem trainer with
# cv2 and PIL blocked: none of them imports either, and only check_videos
# (which decodes videos) needs cv2, and only when it is called
_TRACKING_WITHOUT_OPTIONAL = """
import os, sys, tempfile
BLOCKED = ("cv2", "PIL", "imageio", "transformers")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
from this_and_that_vdm_tpu_torch.curation import (detectors, painters, tools, tracking,
                                                  trajectory, xmem_tracker)
from this_and_that_vdm_tpu_torch.models import flowformer, xmem
from this_and_that_vdm_tpu_torch.training import xmem_trainer
from this_and_that_vdm_tpu_torch.utils import video_io

d = tempfile.mkdtemp()
frames = [np.full((32, 48, 3), 20 * i, np.uint8) for i in range(3)]
for i, f in enumerate(frames):
    f[8:20, 4 + 2 * i:16 + 2 * i] = 200
mask = np.zeros((32, 48), bool)
mask[8:20, 4:16] = True
inst = os.path.join(d, "inst")
os.makedirs(inst)
for i, f in enumerate(frames):
    video_io.write_png(os.path.join(inst, f"im_{i}.jpg"), f)
with open(os.path.join(inst, "data.txt"), "w") as f:
    f.write("0 10.0 12.0\\n")

class Seg:
    def predict_mask(self, image_bgr, points_xy, box_xyxy=None):
        return mask

masks = tracking.track_by_keypoint(inst, Seg(), store_dir=os.path.join(d, "m"), device="cpu")
assert len(masks) == 3
assert video_io.read_png(os.path.join(d, "m", "mask_2.png")).shape == (32, 48, 3)
model = xmem.XMem().eval()
torch.save(model.state_dict(), os.path.join(d, "x.pth"))
got = tracking.XMemPropagator(os.path.join(d, "x.pth"), device="cpu")(frames, mask)
assert len(got) == 3 and got[2].shape == (32, 48)
cfg = xmem_trainer.XMemTrainConfig(num_ref_frames=1)
batch = dict(rgb=torch.zeros(1, 2, 32, 48, 3), first_frame_gt=torch.from_numpy(mask[None, None]
             .astype(np.float32)), cls_gt=torch.zeros(1, 2, 32, 48, dtype=torch.long),
             selector=torch.ones(1, 1))
losses = xmem_trainer.train_step(model.train(), xmem_trainer.make_optimizer(model, cfg), batch,
                                 0, cfg, torch.Generator().manual_seed(0))
assert torch.isfinite(losses["total_loss"]) and losses["grad_norm"] > 0
painted = painters.mask_painter(frames[0], mask)
painted = painters.point_painter(painted, [(10, 12)])
assert painted.shape == (32, 48, 3)
ff = flowformer.FlowFormer(flowformer.FlowFormerConfig.tiny())
flowformer.save_flowformer(os.path.join(d, "f.npz"), ff)
flow = detectors.NativeFlowFormerFlow(os.path.join(d, "f.npz"), device="cpu")(frames[0],
                                                                              frames[1])
assert flow.shape == (32, 48, 2) and painters.flow_to_image(flow).shape == (32, 48, 3)
os.makedirs(os.path.join(d, "v", "a"))
video_io.write_png(os.path.join(d, "v", "a", "0.png"), frames[0])
assert tools.resize_video_seq(os.path.join(d, "v"), os.path.join(d, "r"), (16, 24)) == 1
try:
    tools.check_videos(d)
    raise AssertionError("check_videos ran with no cv2")
except RuntimeError as e:
    assert "cv2" in str(e), e
bad = sorted(m for m in sys.modules if m in ("jax", "this_and_that_vdm_tpu")
             or (m.split(".")[0] in BLOCKED and sys.modules[m] is not None))
print("ok", bad)
"""


def test_tracking_flow_and_trainer_work_without_optional_packages():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _TRACKING_WITHOUT_OPTIONAL], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok []", res.stdout


def _cases():
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    q, k, v = t(1, 256, 2, 64), t(1, 256, 2, 64), t(1, 256, 2, 64)
    x, gw, gb = t(2, 16, 64), t(64), t(64)
    lx, ls, lb, lw, lwb = t(48, 64), t(64), t(64), t(96, 64), t(96)
    g = t(3, 256)
    codes = torch.from_numpy(rng.randint(0, 255, (2, 3, 256)).astype(np.uint8))
    ms, ns = t(3).abs(), t(3).abs()
    bc = adam8bit.bias_corrections(2, 0.9, 0.999)
    return [
        (lambda: flash_attention.flash_attention(q, k, v, 0.125),
         lambda: flash_attention._plain(q, k, v, 0.125)),
        (lambda: groupnorm.group_norm(x, gw, gb, 32, 1e-6, True),
         lambda: groupnorm._plain(x, gw, gb, 32, 1e-6, True)),
        (lambda: ln_matmul.ln_matmul(lx, ls, lb, lw, lwb),
         lambda: ln_matmul._reference(lx, ls, lb, lw, lwb, 1e-5)),
        (lambda: adam8bit.adam8bit_update(g, codes[0], ms, codes[1], ns, bc),
         lambda: adam8bit._plain(g, codes[0], ms, codes[1], ns, bc, 0.9, 0.999, 1e-8)),
    ]


@pytest.mark.parametrize("case", range(4),
                         ids=["flash_attention", "groupnorm", "ln_matmul", "adam8bit"])
def test_cpu_tensor_takes_plain_version_and_launches_nothing(case):
    ops.reset_launch_counts()
    wrapper, plain = _cases()[case]
    torch.testing.assert_close(wrapper(), plain(), rtol=0, atol=0)
    assert ops.launch_counts() == {"flash_attention": 0, "groupnorm": 0, "ln_matmul": 0,
                                   "adam8bit": 0}
    assert _native._lib is None


@pytest.mark.parametrize("kernel", ["flash_attention", "groupnorm", "ln_matmul", "adam8bit"])
def test_non_cpu_non_cuda_tensor_raises(kernel):
    """A wrapper takes its plain version only on the CPU; any other device
    that is not CUDA is refused, never silently computed."""
    m = torch.empty((1, 128, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "flash_attention":
            flash_attention.flash_attention(m, m, m, 0.125)
        elif kernel == "groupnorm":
            groupnorm.group_norm(m.reshape(1, 128, 64), torch.ones(64), torch.zeros(64), 32, 1e-5)
        elif kernel == "ln_matmul":
            ln_matmul.ln_matmul(m.reshape(128, 64), torch.ones(64), torch.zeros(64),
                                torch.zeros(8, 64))
        else:
            q = torch.empty((32, 256), device="meta", dtype=torch.uint8)
            s = torch.empty((32,), device="meta")
            adam8bit.adam8bit_update(m.reshape(32, 256), q, s, q, s, (0.1, 0.001))
