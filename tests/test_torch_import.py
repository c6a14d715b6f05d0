"""The port stands alone: it imports no JAX, builds nothing at import, and
a CPU tensor takes each kernel's plain version without launching anything."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu_torch import ops
from this_and_that_vdm_tpu_torch.ops import _native, flash_attention, groupnorm, ln_matmul

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


def _cases():
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    q, k, v = t(1, 256, 2, 64), t(1, 256, 2, 64), t(1, 256, 2, 64)
    x, gw, gb = t(2, 16, 64), t(64), t(64)
    lx, ls, lb, lw, lwb = t(48, 64), t(64), t(64), t(96, 64), t(96)
    return [
        (lambda: flash_attention.flash_attention(q, k, v, 0.125),
         lambda: flash_attention._plain(q, k, v, 0.125)),
        (lambda: groupnorm.group_norm(x, gw, gb, 32, 1e-6, True),
         lambda: groupnorm._plain(x, gw, gb, 32, 1e-6, True)),
        (lambda: ln_matmul.ln_matmul(lx, ls, lb, lw, lwb),
         lambda: ln_matmul._reference(lx, ls, lb, lw, lwb, 1e-5)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["flash_attention", "groupnorm", "ln_matmul"])
def test_cpu_tensor_takes_plain_version_and_launches_nothing(case):
    ops.reset_launch_counts()
    wrapper, plain = _cases()[case]
    torch.testing.assert_close(wrapper(), plain(), rtol=0, atol=0)
    assert ops.launch_counts() == {"flash_attention": 0, "groupnorm": 0, "ln_matmul": 0}
    assert _native._lib is None


@pytest.mark.parametrize("kernel", ["flash_attention", "groupnorm", "ln_matmul"])
def test_non_cpu_non_cuda_tensor_raises(kernel):
    """A wrapper takes its plain version only on the CPU; any other device
    that is not CUDA is refused, never silently computed."""
    m = torch.empty((1, 128, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "flash_attention":
            flash_attention.flash_attention(m, m, m, 0.125)
        elif kernel == "groupnorm":
            groupnorm.group_norm(m.reshape(1, 128, 64), torch.ones(64), torch.zeros(64), 32, 1e-5)
        else:
            ln_matmul.ln_matmul(m.reshape(128, 64), torch.ones(64), torch.zeros(64),
                                torch.zeros(8, 64))
