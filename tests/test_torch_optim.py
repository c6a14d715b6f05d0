"""The port's 8-bit quantiser, K4's plain version, the optimizers and the EDM
transforms (PyTorch, CPU) against the JAX package, on numpy-seeded inputs.

Tolerances: quantiser codes within 1 on under 0.5% of entries (torch's and
XLA's log2 differ in the last bit, which moves a value sitting on a codebook
midpoint) and decode rtol 1e-6.  K4, both sides given the same blocks: codes
within 1 on under 0.1% per step, scales rtol 1e-6, step atol 1e-6 (|step| is
at most ~1): XLA's and torch's exp2 differ in the last bit at some codebook
magnitudes, the EMA ``b1 * m + (1 - b1) * g`` cancels where the two terms
nearly meet, and that carries a last-bit difference of the decoded moment
into the step's absolute error (measured up to 8.3e-7; 1.8e-7 at the first
step, which decodes nothing, from XLA's fused division).  AdamW (8-bit and
fp32) parameters atol 1e-7 over 6 steps on 1-D leaves at lr 1e-2; EDM rtol
1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from this_and_that_vdm_tpu.ops import adam8bit_pallas as jk4
from this_and_that_vdm_tpu.ops import quant8 as jq8
from this_and_that_vdm_tpu.training import edm as jedm
from this_and_that_vdm_tpu.training import optimizers as jopt
from this_and_that_vdm_tpu.training import trainer as jtrainer

from this_and_that_vdm_tpu_torch.ops import adam8bit, quant8
from this_and_that_vdm_tpu_torch.training import edm, optimizers, trainer


def _codes_close(got, want, share):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < share, (d > 0).mean()


@pytest.mark.parametrize("signed,n_mags", [(True, 127), (False, 255)])
def test_quant8_encode_decode_match_jax(signed, n_mags):
    rng = np.random.RandomState(0)
    mag = 10.0 ** rng.uniform(-8.5, 0.0, 20000)
    v = (mag * (np.sign(rng.randn(mag.size)) if signed else 1.0)).astype(np.float32)
    v[:3] = [0.0, 1.0, 5e-8]
    got = quant8.encode(torch.from_numpy(v), signed, n_mags).numpy()
    want = np.asarray(jq8.encode(jnp.asarray(v), signed, n_mags))
    _codes_close(got, want, 5e-3)
    codes = np.arange(255 if signed else 256, dtype=np.float32)
    np.testing.assert_allclose(quant8.decode(torch.from_numpy(codes), signed, n_mags).numpy(),
                               np.asarray(jq8.decode(jnp.asarray(codes), signed, n_mags)),
                               rtol=1e-6, atol=0)


def test_quantize_roundtrip_matches_jax():
    x = (np.random.RandomState(1).randn(1000) * 3.0).astype(np.float32)
    q = optimizers._quantize(torch.from_numpy(x), signed=True)
    jq = jopt._quantize(jnp.asarray(x), signed=True)
    _codes_close(q.q.numpy(), jq.q, 5e-3)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
    back = optimizers._dequantize(q, x.shape, signed=True).numpy()
    big = np.abs(x) > 1e-6 * np.abs(x).max()
    assert np.all(np.abs(back - x)[big] / np.abs(x)[big] < 0.08)


def test_k4_plain_matches_jax_kernel_and_jnp_path():
    """Six chained updates of one 40-block leaf: JAX's Pallas kernel (in
    interpret mode) carries the state; at every step the port's ``_plain``
    and the JAX jnp path get the same blocks and the same ``bc``."""
    nb, b1, b2, eps = 40, 0.9, 0.999, 1e-8
    rng = np.random.RandomState(2)
    mq = np.full((nb, 256), 127, np.uint8)
    nq = np.zeros((nb, 256), np.uint8)
    ms = np.zeros((nb, 1), np.float32)
    ns = np.zeros((nb, 1), np.float32)
    jnp_state = jopt.scale_by_adam8bit(b1, b2, eps, kernel=False)
    for t in range(1, 7):
        g = (rng.randn(nb, 256) * 10.0 ** rng.uniform(-4, -1, (nb, 1))).astype(np.float32)
        cf = jnp.float32(t)
        bc = jnp.stack([1 - b1 ** cf, 1 - b2 ** cf]).reshape(1, 2)
        kern = [np.asarray(o) for o in jk4._leaf_call(
            jnp.asarray(bc), jnp.asarray(g), jnp.asarray(mq), jnp.asarray(ms), jnp.asarray(nq),
            jnp.asarray(ns), b1=b1, b2=b2, eps=eps, interpret=True)]
        state = jopt.Adam8bitState(
            count=jnp.int32(t - 1), mu=jopt._Q(jnp.asarray(mq.reshape(-1)), jnp.asarray(ms[:, 0])),
            nu=jopt._Q(jnp.asarray(nq.reshape(-1)), jnp.asarray(ns[:, 0])))
        jstep, jstate = jnp_state.update(jnp.asarray(g.reshape(-1)), state)
        got = [o.numpy() for o in adam8bit._plain(
            torch.from_numpy(g), torch.from_numpy(mq), torch.from_numpy(ms[:, 0]),
            torch.from_numpy(nq), torch.from_numpy(ns[:, 0]),
            tuple(float(x) for x in np.asarray(bc)[0]), b1, b2, eps)]
        jnp_out = [np.asarray(jstep).reshape(nb, 256), np.asarray(jstate.mu.q).reshape(nb, 256),
                   np.asarray(jstate.mu.scale), np.asarray(jstate.nu.q).reshape(nb, 256),
                   np.asarray(jstate.nu.scale)]
        for want in (kern, jnp_out):
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
            _codes_close(got[1], want[1], 1e-3)
            _codes_close(got[3], want[3], 1e-3)
            np.testing.assert_allclose(got[2], np.asarray(want[2]).reshape(-1), rtol=1e-6)
            np.testing.assert_allclose(got[4], np.asarray(want[4]).reshape(-1), rtol=1e-6)
        _, mq, ms, nq, ns = kern


def test_k4_tree_plain_matches_jax_kernel_and_jnp_path():
    """Three chained updates of a ragged tree (a 1-block leaf, a 513-element
    leaf, a 41-block leaf, ...) through the port's tree update
    (``adam8bit_leaves``, one call; its plain version on the CPU), held leaf
    by leaf against JAX's Pallas kernel (interpret mode, on the leaf padded to
    whole blocks) and the JAX jnp path, at the tolerances of
    ``test_k4_plain_matches_jax_kernel_and_jnp_path``.  The JAX kernel's
    state carries over; the padded tail keeps the zero codes."""
    numels, b1, b2, eps = [200, 513, 40 * 256 + 17, 256, 1000], 0.9, 0.999, 1e-8
    rng = np.random.RandomState(5)
    nbs = [-(-n // 256) for n in numels]
    mqs = [np.full((nb, 256), 127, np.uint8) for nb in nbs]
    nqs = [np.zeros((nb, 256), np.uint8) for nb in nbs]
    mss = [np.zeros(nb, np.float32) for nb in nbs]
    nss = [np.zeros(nb, np.float32) for nb in nbs]
    jnp_state = jopt.scale_by_adam8bit(b1, b2, eps, kernel=False)
    for t in range(1, 4):
        # magnitudes drawn per block, as in the one-leaf test above
        gs = [(rng.randn(nb, 256) * 10.0 ** rng.uniform(-4, -1, (nb, 1))).astype(np.float32)
              .reshape(-1)[:n] for n, nb in zip(numels, nbs)]
        cf = jnp.float32(t)
        bc = jnp.stack([1 - b1 ** cf, 1 - b2 ** cf]).reshape(1, 2)
        got = adam8bit.adam8bit_leaves(
            [torch.from_numpy(g) for g in gs], [torch.from_numpy(q.reshape(-1)) for q in mqs],
            [torch.from_numpy(x) for x in mss], [torch.from_numpy(q.reshape(-1)) for q in nqs],
            [torch.from_numpy(x) for x in nss], tuple(float(x) for x in np.asarray(bc)[0]),
            b1, b2, eps)
        for i, (g, n, nb) in enumerate(zip(gs, numels, nbs)):
            g2d = np.pad(g, (0, nb * 256 - n)).reshape(nb, 256)
            kern = [np.asarray(o) for o in jk4._leaf_call(
                jnp.asarray(bc), jnp.asarray(g2d), jnp.asarray(mqs[i]),
                jnp.asarray(mss[i][:, None]), jnp.asarray(nqs[i]), jnp.asarray(nss[i][:, None]),
                b1=b1, b2=b2, eps=eps, interpret=True)]
            state = jopt.Adam8bitState(
                count=jnp.int32(t - 1),
                mu=jopt._Q(jnp.asarray(mqs[i].reshape(-1)), jnp.asarray(mss[i])),
                nu=jopt._Q(jnp.asarray(nqs[i].reshape(-1)), jnp.asarray(nss[i])))
            jstep, jstate = jnp_state.update(jnp.asarray(g), state)
            jnp_out = [np.asarray(jstep).reshape(-1), np.asarray(jstate.mu.q),
                       np.asarray(jstate.mu.scale), np.asarray(jstate.nu.q),
                       np.asarray(jstate.nu.scale)]
            kern_out = [kern[0].reshape(-1)[:n], kern[1].reshape(-1), kern[2].reshape(-1),
                        kern[3].reshape(-1), kern[4].reshape(-1)]
            mine = [o[i].numpy() for o in got]
            assert mine[0].shape == (n,) and mine[1].shape == (nb * 256,)
            assert mine[2].shape == (nb,)
            for want in (kern_out, jnp_out):
                np.testing.assert_allclose(mine[0], want[0], rtol=0, atol=1e-6)
                _codes_close(mine[1], want[1], 1e-3)
                _codes_close(mine[3], want[3], 1e-3)
                np.testing.assert_allclose(mine[2], want[2], rtol=1e-6)
                np.testing.assert_allclose(mine[4], want[4], rtol=1e-6)
            assert (mine[1][n:] == 127).all() and (mine[3][n:] == 0).all()
            mqs[i], mss[i] = kern[1], kern[2].reshape(-1)
            nqs[i], nss[i] = kern[3], kern[4].reshape(-1)


def test_k4_tree_plain_matches_jnp_path_per_leaf_draws():
    """The tree update of ``test_k4_tree_plain_matches_jax_kernel_and_jnp_path``
    with each leaf's gradient magnitude drawn per leaf, not per block, held
    against the JAX jnp path alone (JAX's interpret-mode kernel and its jnp
    path differ from each other by up to 1.013e-6 at one element here), at
    the same tolerances; the state carries over from the port's own update."""
    numels, b1, b2, eps = [200, 513, 40 * 256 + 17, 256, 1000], 0.9, 0.999, 1e-8
    rng = np.random.RandomState(5)
    nbs = [-(-n // 256) for n in numels]
    mqs = [np.full(nb * 256, 127, np.uint8) for nb in nbs]
    nqs = [np.zeros(nb * 256, np.uint8) for nb in nbs]
    mss = [np.zeros(nb, np.float32) for nb in nbs]
    nss = [np.zeros(nb, np.float32) for nb in nbs]
    jnp_state = jopt.scale_by_adam8bit(b1, b2, eps, kernel=False)
    for t in range(1, 4):
        gs = [(rng.randn(n) * 10.0 ** rng.uniform(-4, -1)).astype(np.float32) for n in numels]
        got = adam8bit.adam8bit_leaves(
            [torch.from_numpy(g) for g in gs], [torch.from_numpy(q) for q in mqs],
            [torch.from_numpy(x) for x in mss], [torch.from_numpy(q) for q in nqs],
            [torch.from_numpy(x) for x in nss],
            tuple(float(x) for x in np.asarray(jnp.stack([1 - b1 ** jnp.float32(t),
                                                          1 - b2 ** jnp.float32(t)]))),
            b1, b2, eps)
        for i, (g, n, nb) in enumerate(zip(gs, numels, nbs)):
            state = jopt.Adam8bitState(
                count=jnp.int32(t - 1), mu=jopt._Q(jnp.asarray(mqs[i]), jnp.asarray(mss[i])),
                nu=jopt._Q(jnp.asarray(nqs[i]), jnp.asarray(nss[i])))
            jstep, jstate = jnp_state.update(jnp.asarray(g), state)
            mine = [o[i].numpy() for o in got]
            assert mine[0].shape == (n,) and mine[1].shape == (nb * 256,)
            np.testing.assert_allclose(mine[0], np.asarray(jstep).reshape(-1), rtol=0, atol=1e-6)
            _codes_close(mine[1], jstate.mu.q, 1e-3)
            _codes_close(mine[3], jstate.nu.q, 1e-3)
            np.testing.assert_allclose(mine[2], np.asarray(jstate.mu.scale), rtol=1e-6)
            np.testing.assert_allclose(mine[4], np.asarray(jstate.nu.scale), rtol=1e-6)
            assert (mine[1][n:] == 127).all() and (mine[3][n:] == 0).all()
            mqs[i], mss[i], nqs[i], nss[i] = (mine[1].copy(), mine[2].copy(), mine[3].copy(),
                                              mine[4].copy())


def test_bias_corrections_match_jax():
    for t in (1, 2, 7, 1000):
        cf = jnp.float32(t)
        want = np.asarray(jnp.stack([1 - 0.9 ** cf, 1 - 0.999 ** cf]))
        np.testing.assert_allclose(adam8bit.bias_corrections(t, 0.9, 0.999), want, rtol=2e-7)


_LEAVES = {"a": (1000,), "b": (300,), "c": (7,), "d": (256,)}


def _run_optimizer(tcfg, steps=6):
    """The JAX and port optimizers from one TrainConfig on the same 1-D
    parameters and gradients; yields both parameter dicts after each step."""
    rng = np.random.RandomState(3)
    p0 = {k: (0.1 * rng.randn(*s)).astype(np.float32) for k, s in _LEAVES.items()}
    jtx = jtrainer.make_optimizer(tcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ttx = trainer.make_optimizer(trainer.TrainConfig(**dataclasses.asdict(tcfg)), tp)
    tstate = ttx.init(tp)
    for _ in range(steps):
        g = {k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
             for k, s in _LEAVES.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        optimizers.apply_updates(tp, tupd)
        yield {k: np.asarray(v) for k, v in jp.items()}, {k: v.numpy() for k, v in tp.items()}


@pytest.mark.parametrize("use_8bit", [True, False], ids=["adamw8bit", "adamw_fp32"])
@pytest.mark.parametrize("warmup,clip", [(0, None), (3, 1.0)], ids=["plain", "warmup_clip"])
def test_adamw_matches_optax_chain(use_8bit, warmup, clip):
    tcfg = jtrainer.TrainConfig(learning_rate=1e-2, lr_warmup_steps=warmup, max_grad_norm=clip,
                                use_8bit_adam=use_8bit)
    for i, (want, got) in enumerate(_run_optimizer(tcfg)):
        for k in _LEAVES:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=f"{k} {i}")
        if i == 0 and warmup:  # schedule(0) = 0: the first update moves nothing
            assert all(np.array_equal(got[k], want[k]) for k in _LEAVES)


def test_gradient_accumulation_and_partial_finetune_match_optax():
    tcfg = jtrainer.TrainConfig(learning_rate=1e-2, lr_warmup_steps=0,
                                gradient_accumulation_steps=3, use_8bit_adam=True)
    for want, got in _run_optimizer(tcfg):
        for k in _LEAVES:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7)
    assert [trainer._is_partial_trainable(n) for n in (
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
        "time_embedding.linear_1.weight", "down_blocks.0.resnets.0.spatial_res_block.conv1.weight",
        "down_blocks.0.resnets.0.spatial_res_block.time_emb_proj.bias")] == [
        True, True, False, True]


def test_partial_finetune_freezes_unlabelled_parameters():
    tp = {"attn1.w": torch.ones(4), "conv.w": torch.ones(4), "time_embedding.b": torch.ones(4)}
    tcfg = trainer.TrainConfig(learning_rate=1e-1, lr_warmup_steps=0, partial_finetune=True)
    tx = trainer.make_optimizer(tcfg, tp)
    upd, _ = tx.update({k: torch.ones(4) for k in tp}, tx.init(tp), tp)
    assert torch.equal(upd["conv.w"], torch.zeros(4))
    assert (upd["attn1.w"] < 0).all() and (upd["time_embedding.b"] < 0).all()


def test_edm_transforms_match_jax():
    rng = np.random.RandomState(4)
    b = 3
    key = jax.random.PRNGKey(0)
    lat = rng.randn(b, 2, 4, 6, 4).astype(np.float32)
    noise = rng.randn(*lat.shape).astype(np.float32)
    pred = rng.randn(*lat.shape).astype(np.float32)
    jsig = jedm.sample_sigmas(key, b, 0.5, 1.4)
    normal = np.asarray(jax.random.normal(key, (b,), jnp.float32))
    sig = edm.sample_sigmas(None, b, 0.5, 1.4, normal=torch.from_numpy(normal))
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=1e-6)
    got = edm.edm_precondition(torch.from_numpy(lat), torch.from_numpy(noise), sig)
    want = jedm.edm_precondition(jnp.asarray(lat), jnp.asarray(noise), jsig)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        edm.edm_loss(torch.from_numpy(pred), got[0], torch.from_numpy(lat), sig).item(),
        float(jedm.edm_loss(jnp.asarray(pred), want[0], jnp.asarray(lat), jsig)), rtol=1e-6)
    states = rng.randn(b, 5, 8).astype(np.float32)
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(k, (b,)))
        ts, tl = edm.conditioning_dropout(None, torch.from_numpy(states), torch.from_numpy(lat),
                                          0.3, uniform=torch.from_numpy(u))
        js, jl = jedm.conditioning_dropout(k, jnp.asarray(states), jnp.asarray(lat), 0.3)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    u = np.array([0.05, 0.15, 0.5], np.float32)  # drop states / drop both / keep
    ts, tl = edm.conditioning_dropout(None, torch.from_numpy(states), torch.from_numpy(lat), 0.1,
                                      uniform=torch.from_numpy(u))
    assert [bool(ts[i].abs().sum() == 0) for i in range(b)] == [True, True, False]
    assert [bool(tl[i].abs().sum() == 0) for i in range(b)] == [False, True, False]


def test_add_time_ids_are_per_sample():
    cfg = trainer.TrainConfig(process_fps=7, train_noise_aug_strength=0.1)
    ids = trainer.make_add_time_ids(cfg, [120.0, 200.0, 55.0])
    want = jtrainer.make_add_time_ids(jtrainer.TrainConfig(process_fps=7,
                                                           train_noise_aug_strength=0.1),
                                      jnp.asarray([120.0, 200.0, 55.0]))
    np.testing.assert_allclose(ids.numpy(), np.asarray(want), rtol=1e-6)
