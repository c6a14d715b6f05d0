"""``bake_params`` and the pipelines' program cache in the port, on the CPU
(fp32, the tiny configs of ``tests/test_torch_pipeline.py``; the CPU has no
CUDA graphs, so a baked pipeline runs its one step function eagerly):

* the table-driven Euler step against the JAX scheduler's ``step`` over 25
  steps (rtol 1e-6) and against the port's own ``step`` bit for bit;
* (in ``test_torch_bake_one_clip.py`` and ``test_torch_bake_two_clips.py``)
  the baked VGL (standard; guess + ip2p gated) and VL pipelines against the
  JAX pipelines with ``bake_params=True``, at 1 and 2 clips (PARITY.md's
  2e-4), no graph captured;
* the port of ``test_bake_params_matches_default_and_not_stale`` and
  ``test_bake_key_detects_single_leaf_mutation`` (``tests/test_serving_mesh.py``):
  a reassigned non-first tensor changes ``_bake_key``, ``copy_`` and
  ``load_state_dict`` keep it, the ninth key evicts the oldest;
* each ``place_on_mesh`` replica has a cache of its own;
* the CLI bakes unless ``--no-bake``, the app bakes, the rehearsal passes
  ``--no-bake``, training's validation renders stay unbaked.
"""

import argparse
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.schedulers import make_svd_schedule as jax_schedule

from this_and_that_vdm_tpu_torch import app, parallel
from this_and_that_vdm_tpu_torch.cli import inference, rehearsal
from this_and_that_vdm_tpu_torch.pipelines import svd as psvd
from this_and_that_vdm_tpu_torch.schedulers import (make_svd_schedule, table_scale_model_input,
                                                    table_step)
from this_and_that_vdm_tpu_torch.training import train_loop, validation

from test_torch_pipeline import FR, H, W, pipes  # noqa: F401  (fixture)
from torch_bake_parity import _inputs, _vgl
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


# ------------------------------------------------------------- the scheduler

@pytest.mark.parametrize("steps", [25, 4])
def test_table_step_matches_jax_scheduler(steps):
    js, ts = jax_schedule(steps), make_svd_schedule(steps)
    table = torch.from_numpy(ts.step_table())
    assert table.shape == (steps, 6) and table.dtype == torch.float32
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4, 5, 4).astype(np.float32) * float(ts.init_noise_sigma)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        out = rng.randn(*x.shape).astype(np.float32)
        np.testing.assert_allclose(table_scale_model_input(tx, table[i]).numpy(),
                                   np.asarray(js.scale_model_input(jx, i)), rtol=1e-6)
        got = table_step(torch.from_numpy(out), table[i], tx)
        # the table step is the port's own step, bit for bit, on the CPU
        assert torch.equal(got, ts.step(torch.from_numpy(out), i, tx))
        jx = js.step(jnp.asarray(out), i, jx)
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        tx = got
    assert float(table[0, 0]) == float(ts.timesteps[0])


def test_denoise_table_columns():
    table, sigma0 = psvd.denoise_table(5, "cpu", cn_scale=[0.8, 0.8, 0.0, 0.0, 0.0],
                                       image_guidance_scale=2.0)
    assert table.shape == (5, 8) and sigma0 == make_svd_schedule(5).init_noise_sigma
    np.testing.assert_array_equal(table[:, :6].numpy(), make_svd_schedule(5).step_table())
    np.testing.assert_array_equal(table[:, psvd.CN_SCALE].numpy(),
                                  np.float32([0.8, 0.8, 0, 0, 0]))
    assert (table[:, psvd.IMG_SCALE] == 2.0).all()


# ------------------------------------------------------------- the bake key

def test_bake_params_matches_default_and_not_stale(pipes):  # noqa: F811
    _, t = pipes
    image, cond_img, noise, kw = _inputs(2, 1)
    kw = dict(kw, output_type="latent")
    default = _vgl(t, bake=False)(image, cond_img, latents=noise, **kw)
    # copies of the fixture's modules, so that zeroing them corrupts nothing
    mods = {k: copy.deepcopy(m) for k, m in t.items()}
    baked = _vgl(mods)
    out1 = baked(image, cond_img, latents=noise, **kw)
    np.testing.assert_array_equal(out1, default)
    # swapping the weights must change what the baked pipeline serves
    for name in ("unet", "controlnet"):
        for p in mods[name].parameters():
            p.data = torch.zeros_like(p)
    out2 = baked(image, cond_img, latents=noise, **kw)
    assert not np.allclose(out1, out2, atol=1e-3)


def _last_param(module):
    """(owning module, attribute name) of the module's last parameter."""
    name = list(dict(module.named_parameters()))[-1]
    path, attr = name.rsplit(".", 1)
    return module.get_submodule(path), attr


def test_bake_key_detects_single_tensor_reassignment(pipes):  # noqa: F811
    _, t = pipes
    mods = {k: copy.deepcopy(m) for k, m in t.items()}
    pipe = _vgl(mods)
    k1 = pipe._bake_key()
    assert k1 is not None and len(k1[1]) == len(list(mods["controlnet"].parameters()))
    owner, attr = _last_param(mods["controlnet"])  # a non-first tensor
    old = getattr(owner, attr)
    setattr(owner, attr, torch.nn.Parameter(old.detach().clone(), requires_grad=False))
    assert pipe._bake_key() != k1
    setattr(owner, attr, old)
    assert pipe._bake_key() == k1
    # in place (copy_, load_state_dict): the key stays
    with torch.no_grad():
        old.copy_(old * 2.0)
    mods["unet"].load_state_dict({"conv_out.bias": torch.ones_like(mods["unet"].conv_out.bias)},
                                 strict=False)
    assert pipe._bake_key() == k1
    # the UNet's tensors count too, and an unbaked pipeline has no key
    owner, attr = _last_param(mods["unet"])
    setattr(owner, attr, torch.nn.Parameter(getattr(owner, attr).detach().clone()))
    assert pipe._bake_key() != k1
    assert _vgl(mods, bake=False)._bake_key() is None


def test_step_key_holds_what_the_graph_bakes_in(pipes):  # noqa: F811
    _, t = pipes
    pipe = _vgl(t)
    x = torch.zeros((1, FR, H // 8, W // 8, 4))
    inputs = dict(states=torch.zeros((2, 2, 48)), add_ids=torch.zeros((2, 3)))
    key = pipe._step_key("denoise_cn", x, inputs, False, False)
    assert key[-1] == pipe._bake_key()
    others = [pipe._step_key("denoise", x, inputs, False, False),
              pipe._step_key("denoise_cn", x, inputs, True, False),
              pipe._step_key("denoise_cn", x, inputs, False, True),
              pipe._step_key("denoise_cn", torch.zeros((2,) + x.shape[1:]), inputs, False, False),
              pipe._step_key("denoise_cn", x.double(), dict(inputs, states=torch.zeros((2, 3, 48))),
                             False, False)]
    assert len({key, *others}) == 1 + len(others)


def test_program_cache_evicts_the_oldest_of_nine(pipes):  # noqa: F811
    _, t = pipes
    pipe = _vgl(t)
    built = []

    def build(i):
        built.append(i)
        return f"program {i}"

    for i in range(pipe._FN_CACHE_LIMIT):
        assert pipe._cached_fn(("k", i), lambda i=i: build(i)) == f"program {i}"
    assert pipe._cached_fn(("k", 0), lambda: build("again")) == "program 0"
    assert built == list(range(8))
    pipe._cached_fn(("k", 8), lambda: build(8))
    assert len(pipe._fn_cache) == 8 and ("k", 0) not in pipe._fn_cache
    assert list(pipe._fn_cache)[0] == ("k", 1) and pipe.step_graphs()[-1] == "program 8"


def test_place_on_mesh_gives_each_replica_its_own_cache(pipes):  # noqa: F811
    _, t = pipes
    pipe = _vgl(t)
    pipe._cached_fn(("before",), lambda: "stale")
    pipe.place_on_mesh(parallel.make_serving_mesh(["cpu"] * 2, cfg=1))
    assert pipe._fn_cache == {}  # a mesh clears the cache, as JAX does
    (rep,) = pipe._replicas.values()
    assert rep.bake_params and rep._fn_cache is not pipe._fn_cache
    assert rep._lock is not pipe._lock and rep.captures == 0
    rep._cached_fn(("replica",), lambda: "program")
    assert ("replica",) not in pipe._fn_cache


# ----------------------------------------------------------- entry points

def test_cli_bakes_unless_no_bake():
    args = inference.parser().parse_args(["--random-weights", "--device", "cpu", "--dtype",
                                          "f32"])
    assert not args.no_bake and inference.build_pipeline(args).bake_params
    args = inference.parser().parse_args(["--random-weights", "--device", "cpu", "--dtype",
                                          "f32", "--no-bake"])
    assert args.no_bake and not inference.build_pipeline(args).bake_params


def test_app_bakes_through_the_cli():
    pipe, _ = app.build_pipeline(random_weights=True, dtype="f32", device="cpu")
    assert pipe.bake_params


def test_rehearsal_renders_unbaked(monkeypatch, tmp_path):
    from this_and_that_vdm_tpu_torch.cli import eval as eval_cli

    argvs = []
    monkeypatch.setattr(rehearsal, "synthesize_hf_repo", lambda *a, **k: str(tmp_path))
    monkeypatch.setattr(rehearsal, "_perturb_unet", lambda repo: None)
    monkeypatch.setattr(inference, "main", lambda argv: argvs.append(argv) or ["rendered"])
    gates = iter([True, False])
    monkeypatch.setattr(eval_cli, "evaluate_trees",
                        lambda *a, **k: dict(gate_pass=next(gates), n_instances=1))
    assert rehearsal.main(["--out", str(tmp_path), "--device", "cpu",
                           "--validation-path", str(tmp_path)]) == 0
    assert len(argvs) == 3 and all("--no-bake" in a for a in argvs)


@pytest.mark.parametrize("mode", ["vgl", "vl"])
def test_validation_renders_unbaked(monkeypatch, tmp_path, mode):
    seen = []
    monkeypatch.setattr(validation, "render_validation",
                        lambda step, out, pipe, *a, **k: seen.append(pipe) or [])
    args = argparse.Namespace(mode=mode)
    dcfg = argparse.Namespace(video_seq_length=FR, height=H, width=W)
    models = dict(unet=None, vae=None, image_encoder=None, text_encoder=None, controlnet=None)
    train_loop._validate(args, dict(validation_img_folder=str(tmp_path)), dcfg, models, None,
                         str(tmp_path), step=1, write=False)
    (pipe,) = seen
    assert not pipe.bake_params and pipe.captures == 0
