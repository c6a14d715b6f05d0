"""The port's FlowFormer (``models/flowformer.py``) and its ``.npz`` format
against the JAX module, on the CPU.

The JAX ``tiny()`` model is initialised from ``jax.random.PRNGKey`` (GMA's
gamma set to 0.5, so the global motion term counts), saved with
``flowformer_params_save`` and loaded by the port; the port's archive is
loaded by ``flowformer_params_load``: both ways bit-equal.  The flow of
every decoder iteration and the upsampled flow agree within 1e-4 of their
largest magnitude; ``NativeFlowFormerFlow`` (padding a frame size that is
not a multiple of 8) against the JAX wrapper within the same bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from this_and_that_vdm_tpu.curation import detectors as jdet
from this_and_that_vdm_tpu.models import flowformer as jff

from this_and_that_vdm_tpu_torch.curation import detectors, trajectory
from this_and_that_vdm_tpu_torch.models import flowformer as ff
from this_and_that_vdm_tpu_torch.weights.convert import (flax_flowformer_params_to_torch,
                                                         read_flowformer_npz)

from torch_one_thread import one_torch_thread  # noqa: F401

TOL = 1e-4  # relative to the largest magnitude of the JAX flow


def images(h=32, w=48, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, h, w, 3) * 255).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """(path, JAX params) of a JAX-written tiny archive."""
    cfg = jff.FlowFormerConfig.tiny()
    im1, im2 = images()
    init = jax.jit(jff.FlowFormer(cfg).init)  # compiled: faster than the eager init
    params = flax.core.unfreeze(init(jax.random.PRNGKey(0), jnp.asarray(im1), jnp.asarray(im2)))
    params["params"]["update_block"]["gma"]["gamma"] = jnp.float32(0.5)
    path = str(tmp_path_factory.mktemp("ff") / "jax.npz")
    jff.flowformer_params_save(path, params, cfg)
    return path, params


def close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))


def test_config_matches_jax():
    for name in ("sintel", "tiny"):
        got = dataclasses.asdict(getattr(ff.FlowFormerConfig, name)())
        assert got == dataclasses.asdict(getattr(jff.FlowFormerConfig, name)())
    assert ff.FlowFormerConfig.sintel().decoder_depth == 12


def test_archives_round_trip_both_ways(archive, tmp_path):
    path, params = archive
    model = ff.load_flowformer(path)  # the config from the archive
    assert model.cfg == ff.FlowFormerConfig.tiny()
    want = flax_flowformer_params_to_torch(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and np.array_equal(got[k].numpy(), want[k]), k
    # the port's archive in JAX: the config and every array bit-equal
    out = str(tmp_path / "port.npz")
    ff.save_flowformer(out, model)
    assert jff.flowformer_config_from_archive(out) == jff.FlowFormerConfig.tiny()
    back = jff.flowformer_params_load(out)
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        assert np.array_equal(np.asarray(v), np.asarray(flat_b[k])), jax.tree_util.keystr(k)
    _, cfg = read_flowformer_npz(out)
    assert ff.FlowFormerConfig.from_dict(cfg) == ff.FlowFormerConfig.tiny()


def test_window_fold_matches_jax():
    x = np.random.RandomState(0).randn(2, 10, 13, 5).astype(np.float32)
    t, ph, pw = ff._window_fold(torch.from_numpy(x), 4)
    jt, jph, jpw = jff._window_fold(jnp.asarray(x), 4)
    assert (ph, pw) == (jph, jpw) and np.array_equal(t.numpy(), np.asarray(jt))
    back = ff._window_unfold(t, 2, 10, 13, 4, ph, pw)
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("iters", [1, 3])
def test_flow_of_every_iteration_matches_jax(archive, iters):
    path, params = archive
    model = ff.load_flowformer(path)
    im1, im2 = images(seed=iters)
    jmodel = jff.FlowFormer(jff.FlowFormerConfig.tiny())
    fwd = jax.jit(lambda p, a, b: jff.flowformer_forward(jmodel, p, a, b, iters=iters,
                                                         return_all=True))  # eager is ~10x slower
    j_low, j_up, j_all = fwd(params, jnp.asarray(im1), jnp.asarray(im2))
    with torch.no_grad():
        low, up, every = ff.flowformer_forward(model, torch.from_numpy(im1),
                                               torch.from_numpy(im2), iters=iters,
                                               return_all=True)
    assert every.shape == (iters, 1, 4, 6, 2) and up.shape == (1, 32, 48, 2)
    for i in range(iters):
        close(every[i], j_all[i])
    close(low, j_low)
    close(up, j_up)


def test_native_wrapper_matches_jax(archive):
    path, _ = archive
    rng = np.random.RandomState(4)
    a, b = (rng.randint(0, 256, (30, 45, 3)).astype(np.uint8) for _ in range(2))
    port = detectors.NativeFlowFormerFlow(path, device="cpu")
    ref = jdet.NativeFlowFormerFlow(path)
    assert port.iters == ref.iters == 3  # the archive's decoder_depth
    got = port(a, b)
    assert got.shape == (30, 45, 2) and got.dtype == np.float32
    close(got, ref(a, b))


def test_the_card_is_the_default(archive, tmp_path):
    """Without ``device="cpu"`` / ``--device cpu`` the wrapper and the
    trajectory CLI want the card: where there is none they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path, _ = archive
    with pytest.raises(RuntimeError, match="cuda"):
        detectors.NativeFlowFormerFlow(path)
    with pytest.raises(RuntimeError, match="cuda"):
        trajectory.main([str(tmp_path), "--native-flowformer", path])
