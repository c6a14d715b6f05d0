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


# the card-path modules with the optional packages blocked: import fails
# for each of them, as where they are not installed
_WITHOUT_OPTIONAL = """
import os, sys, tempfile
BLOCKED = ("cv2", "PIL", "imageio", "transformers", "safetensors", "regex")
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
from this_and_that_vdm_tpu_torch.cli import eval, inference, rehearsal, sweep, tokenizer
from this_and_that_vdm_tpu_torch.data import bridge, image, rasterize
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
