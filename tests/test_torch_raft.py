"""The port's RAFT (``models/raft.py``) against the JAX module, on the CPU.

An official (princeton-vl) state dict with the ``module.`` prefix is made
from a numpy seed with the port module's own names and shapes; it reaches
JAX through ``raft_state_dict_to_flax`` and the port, prefix stripped,
through ``load_state_dict(strict=True)``.  Flow agrees within 1e-4 of its
scale after 3 and 5 iterations; the weight round trip is bit-equal; the
correlation lookup keeps the reference's transposed window order; the
native wrapper pads and unpads as the JAX one does.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.curation import detectors as jdet
from this_and_that_vdm_tpu.models import raft as jraft
from this_and_that_vdm_tpu.weights.convert import raft_state_dict_to_flax

from this_and_that_vdm_tpu_torch.curation import detectors
from this_and_that_vdm_tpu_torch.models import raft
from this_and_that_vdm_tpu_torch.weights.convert import flax_raft_params_to_torch

from torch_one_thread import one_torch_thread  # noqa: F401

CFG = raft.RAFTConfig.tiny()
JCFG = jraft.RAFTConfig.tiny()


def official_state_dict(module: torch.nn.Module, seed: int = 0):
    """Seeded values; ``norm3`` and ``downsample.1`` are one module, so they
    share their tensors as in a real checkpoint."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if ".norm3." in k:
            continue
        if not v.is_floating_point():
            sd[k] = v.numpy()
        elif k.endswith("running_var"):
            sd[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            sd[k] = (rng.randn(*v.shape) * (0.3 if "running_mean" in k else 0.1)).astype(np.float32)
    for k in list(sd):
        if ".downsample.1." in k:
            sd[k.replace(".downsample.1.", ".norm3.")] = sd[k]
    return sd


@pytest.fixture(scope="module")
def pair():
    model = raft.RAFT(CFG).eval()
    sd = official_state_dict(model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    params = raft_state_dict_to_flax({f"module.{k}": v for k, v in sd.items()})
    return sd, params, model


def images(h=32, w=48, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (1, h, w, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("iters", [3, 5])
def test_flow_matches_jax(pair, iters):
    _, params, model = pair
    i1, i2 = images(seed=iters)
    j_low, j_up = jraft.raft_forward(jraft.RAFT(JCFG), params, jnp.asarray(i1), jnp.asarray(i2),
                                     iters=iters)
    with torch.no_grad():
        low, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=iters)
    assert up.shape == (1, 32, 48, 2) and low.shape == (1, 4, 6, 2)
    for got, want in ((low, j_low), (up, j_up)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1.0))


def test_weight_round_trip_is_bit_equal(pair):
    sd, params, model = pair
    back = flax_raft_params_to_torch(params)
    assert set(back) == set(sd) == set(model.state_dict())
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k


def test_config_from_state_dict(pair):
    sd, _, _ = pair
    got = raft.RAFTConfig.from_state_dict(sd, corr_levels=CFG.corr_levels)
    assert dataclasses.replace(got, iters=CFG.iters) == CFG
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jraft.RAFTConfig.from_state_dict(sd, corr_levels=CFG.corr_levels))
    large = raft.RAFT(raft.RAFTConfig.large())
    assert raft.RAFTConfig.from_state_dict(large.state_dict()) == raft.RAFTConfig.large()


def test_lookup_keeps_the_transposed_window_order():
    """Channel k = i*(2r+1)+j samples x + d[i], y + d[j], as the JAX lookup
    (and the reference CorrBlock) does; the natural order differs."""
    rng = np.random.RandomState(1)
    b, h, w, r = 1, 4, 6, 2
    vol = rng.randn(b * h * w, h, w).astype(np.float32)
    coords = (rng.rand(b, 2, h, w) * [[[w - 1]], [[h - 1]]]).astype(np.float32)
    got = raft.lookup_corr([torch.from_numpy(vol)], torch.from_numpy(coords), r)
    want = jraft.lookup_corr([jnp.asarray(vol[..., None])],
                             jnp.asarray(coords.transpose(0, 2, 3, 1)), r)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6)
    natural = got.reshape(b, 2 * r + 1, 2 * r + 1, h, w).transpose(1, 2).reshape(got.shape)
    assert (natural - got).abs().max() > 1e-2


def test_native_flow_wrapper_matches_jax(pair):
    """Frames that are not multiples of 8: replicate padding and the crop."""
    _, params, model = pair
    rng = np.random.RandomState(2)
    f1, f2 = (rng.randint(0, 256, (27, 38, 3), np.uint8) for _ in range(2))
    got = detectors.NativeRAFTFlow(model=model, iters=3, device="cpu")(f1, f2)
    want = jdet.NativeRAFTFlow(params=params, cfg=JCFG, iters=3)(f1, f2)
    assert got.shape == want.shape == (27, 38, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1.0))
    assert raft.pad_to_multiple(f1)[1] == jraft.pad_to_multiple(f1)[1]
    assert np.array_equal(raft.pad_to_multiple(f1)[0], jraft.pad_to_multiple(f1)[0])
