"""The port's ops (PyTorch, CPU) against the JAX package.

The kernels' plain versions — what a CPU tensor takes — are held against
the JAX Pallas kernels run in interpret mode (as tests/test_flash_attention,
test_groupnorm_pallas and test_ln_matmul run them) and against the JAX plain
paths.  Inputs are numpy draws from a seed, fed to both sides, all fp32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from this_and_that_vdm_tpu.models.layers import _group_norm as jax_group_norm
from this_and_that_vdm_tpu.ops import flash_attention as jfa
from this_and_that_vdm_tpu.ops import groupnorm_pallas as jgn
from this_and_that_vdm_tpu.ops import ln_matmul as jlm
from this_and_that_vdm_tpu.ops.resize import resize_with_antialiasing as jax_resize
from this_and_that_vdm_tpu.schedulers import make_svd_schedule as jax_schedule

from this_and_that_vdm_tpu_torch.ops import attention, flash_attention, groupnorm, ln_matmul
from this_and_that_vdm_tpu_torch.ops.resize import resize_with_antialiasing
from this_and_that_vdm_tpu_torch.schedulers import make_svd_schedule


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_flash_plain_matches_pallas_kernel_interpret():
    rng = np.random.RandomState(0)
    b, s, h, d = 2, 512, 3, 64
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              scale=d ** -0.5))
    got = flash_attention.flash_attention(_t(q), _t(k), _t(v), d ** -0.5).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 1536, 5, 64), (2, 384, 10, 64), (2, 256, 2, 128),
                                   (2, 78, 5, 64), (2, 14, 5, 64), (2, 1536, 1, 512),
                                   (2, 257, 16, 80)])
def test_flash_dispatch_rule_is_the_jax_rule(shape):
    """The same sites take the kernel in both packages: JAX supports()
    without its backend check (spatial S=1536/384 at D=64 yes; cross,
    temporal, VAE D=512 and CLIP D=80 no)."""
    q = torch.zeros(shape)
    rule = (jfa._block_q(shape[1]) is not None and shape[1] <= 4096
            and shape[3] in jfa._SUPPORTED_HEAD_DIM)
    assert flash_attention.supports(q, q, q) == rule
    assert not flash_attention.supports(q, q[:, :7], q[:, :7])  # cross-attention


def test_dot_product_attention_matches_jax_xla_path():
    from this_and_that_vdm_tpu.ops.attention import _xla_attention

    rng = np.random.RandomState(1)
    q = rng.randn(2, 78, 2, 64).astype(np.float32)
    k = rng.randn(2, 40, 2, 64).astype(np.float32)
    v = rng.randn(2, 40, 2, 64).astype(np.float32)
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125))
    got = attention.dot_product_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("with_silu", [False, True])
def test_groupnorm_plain_matches_pallas_kernel_interpret(with_silu):
    rng = np.random.RandomState(0)
    n, s, c, g = 3, 64, 256, 32
    x = rng.randn(n, s, c).astype(np.float32)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias), g, 1e-5, with_silu))
    got = groupnorm.group_norm(_t(x), _t(scale), _t(bias), g, 1e-5, with_silu).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_groupnorm_constant_input_is_finite():
    c, g = 256, 32
    x = np.full((2, 16, c), 3.0, np.float32)
    scale = np.ones(c, np.float32)
    bias = np.linspace(-1, 1, c).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias), g, 1e-6, False))
    got = groupnorm.group_norm(_t(x), _t(scale), _t(bias), g, 1e-6).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(bias, got.shape), atol=1e-2)


def test_groupnorm_rank5_folds_frames_into_statistics():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 4, 6, 64) * 2 + 1).astype(np.float32)
    scale = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     32, 1e-5))
    got = groupnorm.group_norm(_t(x), _t(scale), _t(bias), 32, 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("r,c,n,bias", [(512, 128, 384, False), (256, 320, 960, False),
                                        (272, 128, 256, True)])
def test_ln_matmul_plain_matches_pallas_kernel_interpret(r, c, n, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(r, c).astype(np.float32)
    s = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    w = (rng.randn(c, n) / np.sqrt(c)).astype(np.float32)
    wb = (0.1 * rng.randn(n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jlm._ln_matmul_pallas_local(
            jnp.asarray(x), jnp.asarray(s).reshape(1, c), jnp.asarray(b).reshape(1, c),
            jnp.asarray(w), jnp.asarray(wb if bias else np.zeros(n, np.float32)).reshape(1, n),
            eps=1e-5))
    got = ln_matmul.ln_matmul(_t(x), _t(s), _t(b), _t(w.T.copy()),
                              _t(wb) if bias else None).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_ln_matmul_folds_leading_dims_like_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 12, 64).astype(np.float32)
    s, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    w = rng.randn(64, 96).astype(np.float32) / 8
    wb = rng.randn(96).astype(np.float32)
    want = np.asarray(jlm.ln_matmul(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                    jnp.asarray(w), jnp.asarray(wb)))
    got = ln_matmul.ln_matmul(_t(x), _t(s), _t(b), _t(w.T.copy()), _t(wb)).numpy()
    assert got.shape == (4, 12, 96)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("shape,size", [((2, 3, 256, 384), (224, 224)),
                                        ((1, 3, 100, 50), (224, 224))])
def test_resize_matches_jax(shape, size):
    img = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(img), size))
    got = resize_with_antialiasing(_t(img), size).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_scheduler_matches_jax():
    js, ts = jax_schedule(25), make_svd_schedule(25)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.init_noise_sigma == js.init_noise_sigma
    rng = np.random.RandomState(4)
    x = rng.randn(1, 3, 4, 6, 4).astype(np.float32) * ts.init_noise_sigma
    jx, tx = jnp.asarray(x), _t(x)
    for i in range(3):
        out = rng.randn(*x.shape).astype(np.float32)
        np.testing.assert_allclose(ts.scale_model_input(tx, i).numpy(),
                                   np.asarray(js.scale_model_input(jx, i)), rtol=1e-6)
        jx = js.step(jnp.asarray(out), i, jx)
        tx = ts.step(_t(out), i, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
