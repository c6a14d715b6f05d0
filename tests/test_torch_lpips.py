"""The port's LPIPS (utils/lpips.py) against the JAX LPIPS on seeded
AlexNet / lin weights (CPU, fp32): the distances within rtol 1e-5 at
64x64 and at the 35x35 minimum; ``video_lpips`` on uint8 frames; the eval
CLI's ``--lpips-weights`` in the nested and the flat layout and
``--lpips-alexnet`` / ``--lpips-lin``, with LPIPS in the report (as
``tests/test_eval_cli.py`` drives the JAX CLI); the JAX converter golden
reproduced."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.utils import lpips as jlpips

from this_and_that_vdm_tpu_torch.cli import eval as eval_cli
from this_and_that_vdm_tpu_torch.utils import lpips, video_io

RTOL = 1e-5


def _states(seed=0):
    """Seeded torchvision-layout AlexNet ``features`` and LPIPS heads."""
    gen = torch.Generator().manual_seed(seed)
    alex = {}
    for idx, cin, cout, k, _, _ in lpips._ALEX_CONVS:
        alex[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.01
    lin = {f"lin{j}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen) * 0.1
           for j, c in enumerate(lpips.CHANNELS)}
    return alex, lin


def _jax_params(alex, lin):
    to_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    return jlpips.lpips_params_from_torch(to_np(alex), to_np(lin))


@pytest.mark.parametrize("hw", [(64, 64), (35, 35), (48, 80)])
def test_lpips_matches_jax(hw):
    alex, lin = _states()
    rng = np.random.RandomState(hw[0])
    x = rng.uniform(-1, 1, (3,) + hw + (3,)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    model = lpips.lpips_model(alex, lin, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jlpips.lpips_fn(_jax_params(alex, lin))(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (got > 0).all()
    with torch.no_grad():
        assert model(torch.from_numpy(x), torch.from_numpy(x)).abs().max() < 1e-6


def test_video_lpips_matches_jax_and_golden():
    alex, lin = _states()
    model = lpips.lpips_model(alex, lin, "cpu")
    rng = np.random.RandomState(1)
    a = rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-40, 41, a.shape), 0, 255).astype(np.uint8)
    got = lpips.video_lpips(model, a, b)
    want = jlpips.video_lpips(_jax_params(alex, lin), a, b)
    assert got == pytest.approx(want, rel=RTOL)
    assert lpips.video_lpips(model, a / 255.0, b / 255.0) == pytest.approx(got, rel=RTOL)
    assert lpips.video_lpips(model, a, a) < 1e-6


def _frames(seed, n=3, h=40, w=48):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]


def _write(root, name, frames):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    for i, fr in enumerate(frames):
        video_io.write_png(os.path.join(d, f"{i}.png"), fr)


@pytest.mark.parametrize("layout", ["nested", "flat", "two_files"])
def test_eval_cli_lpips_flags(tmp_path, layout):
    alex, lin = _states(seed=2)
    if layout == "two_files":
        torch.save(alex, tmp_path / "alex.pth")
        torch.save(lin, tmp_path / "lin.pth")
        flags = ["--lpips-alexnet", str(tmp_path / "alex.pth"),
                 "--lpips-lin", str(tmp_path / "lin.pth")]
    else:
        blob = {"alexnet": alex, "lin": lin} if layout == "nested" else {**alex, **lin}
        torch.save(blob, tmp_path / "lpips.pth")
        flags = ["--lpips-weights", str(tmp_path / "lpips.pth")]
    a, b, c = (str(tmp_path / x) for x in "abc")
    fa, fc = _frames(3), _frames(4)
    _write(a, "inst", fa)
    _write(b, "inst", fa)
    _write(c, "inst", fc)
    out = str(tmp_path / "report.json")
    assert eval_cli.main([a, b, "--psnr-gate", "35", "--device", "cpu", "--out", out]
                         + flags) == 0
    with open(out) as f:
        rep = json.load(f)
    assert rep["gate_pass"] and rep["instances"]["inst"]["lpips_mean"] < 1e-6
    assert eval_cli.main([a, c, "--device", "cpu", "--out", out] + flags) == 0
    with open(out) as f:
        got = json.load(f)["instances"]["inst"]["lpips_mean"]
    want = jlpips.video_lpips(_jax_params(alex, lin), np.stack(fa), np.stack(fc))
    assert got > 0 and got == pytest.approx(round(want, 5), abs=1.5e-5)


def test_eval_lpips_needs_both_files_or_one():
    assert eval_cli._load_lpips(None, None) is None
    assert eval_cli._load_lpips("alex.pth", None) is None


def test_port_reproduces_jax_converter_golden():
    from test_eval_cli import GOLDEN_LPIPS, _synthetic_lpips_states

    model = lpips.lpips_model(*_synthetic_lpips_states(seed=0), "cpu")
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 255, (2, 35, 35, 3)).astype(np.uint8)
    b = rng.uniform(0, 255, (2, 35, 35, 3)).astype(np.uint8)
    assert abs(lpips.video_lpips(model, a, b) - GOLDEN_LPIPS) < 2e-4
