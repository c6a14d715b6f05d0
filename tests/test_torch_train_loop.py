"""The port's training plumbing (PyTorch, CPU) against the JAX package.

The autograd wiring of K1-K3: each ``torch.autograd.Function`` with its
launch replaced by the plain forward, against ``jax.vjp`` of the JAX
kernels' ``custom_vjp`` (Pallas in interpret mode), within 1e-5 of the
largest gradient.  ``remat`` on against off (the same outputs, gradients
within 1e-6).  ``controlnet_from_unet`` against ``controlnet_params_from_unet``
(exact).  Checkpoint save / restore / rotation, and ``train_loop.main`` at
nano size on the CPU with resume from ``latest``.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from this_and_that_vdm_tpu.models import controlnet as jcn
from this_and_that_vdm_tpu.models import unet as junet
from this_and_that_vdm_tpu.models.layers import _fused_group_norm as jax_fused_gn
from this_and_that_vdm_tpu.ops import flash_attention as jfa
from this_and_that_vdm_tpu.ops import ln_matmul as jlm
from this_and_that_vdm_tpu.weights.convert import controlnet_params_from_unet

from this_and_that_vdm_tpu_torch.models import controlnet, unet
from this_and_that_vdm_tpu_torch.ops import flash_attention, groupnorm, ln_matmul
from this_and_that_vdm_tpu_torch.training import checkpoint as ckpt
from this_and_that_vdm_tpu_torch.training import optimizers, train_loop, trainer
from this_and_that_vdm_tpu_torch.weights.convert import controlnet_from_unet, flax_params_to_torch

from test_torch_models import jax_params, port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, H, W = 2, 3, 64, 128
CTX = 48


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ----------------------------------------------------- autograd through K1-K3

def _t(a, grad=True):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_flash_attention_function_gradients_match_jax_vjp(monkeypatch):
    monkeypatch.setattr(flash_attention, "_launch", flash_attention._plain)
    rng = np.random.RandomState(0)
    q, k, v, g = (rng.randn(2, 256, 2, 64).astype(np.float32) for _ in range(4))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = flash_attention._FlashAttention.apply(tq, tk, tv, 0.125)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale=0.125),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b) < 1e-5


@pytest.mark.parametrize("with_silu", [False, True])
def test_groupnorm_function_gradients_match_jax_vjp(monkeypatch, with_silu):
    monkeypatch.setattr(groupnorm, "_launch", groupnorm._plain)
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 64, 256) * 2 + 0.5).astype(np.float32)
    s, b = (1 + 0.1 * rng.randn(256)).astype(np.float32), (0.1 * rng.randn(256)).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    tx, ts, tb = _t(x), _t(s), _t(b)
    out = groupnorm._GroupNorm.apply(tx, ts, tb, 32, 1e-6, with_silu)
    got = torch.autograd.grad(out, (tx, ts, tb), torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, c, d: jax_fused_gn(a, c, d, 32, 1e-6, with_silu),
                         jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
        want = vjp(jnp.asarray(g))
    for a, w in zip(got, want):
        assert _rel(a.numpy(), w) < 1e-5


@pytest.mark.parametrize("bias", [False, True])
def test_ln_matmul_function_gradients_match_jax_vjp(monkeypatch, bias):
    monkeypatch.setattr(ln_matmul, "_launch", ln_matmul._reference)
    rng = np.random.RandomState(2)
    x = rng.randn(256, 128).astype(np.float32)
    s, b = (1 + 0.1 * rng.randn(128)).astype(np.float32), (0.1 * rng.randn(128)).astype(np.float32)
    w = (rng.randn(128, 384) / np.sqrt(128)).astype(np.float32)
    wb = (0.1 * rng.randn(384)).astype(np.float32)
    g = rng.randn(256, 384).astype(np.float32)
    ins = [_t(x), _t(s), _t(b), _t(w.T.copy()), _t(wb) if bias else None]
    out = ln_matmul._LnMatmul.apply(*ins, 1e-5)
    got = torch.autograd.grad(out, [t for t in ins if t is not None], torch.from_numpy(g))
    jins = [jnp.asarray(a) for a in (x, s, b, w)] + ([jnp.asarray(wb)] if bias else [])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: jlm._ln_matmul(*a, *([None] * (not bias)), 1e-5), *jins)
        want = list(vjp(jnp.asarray(g)))
    want[3] = np.asarray(want[3]).T  # w: JAX (C, N), torch (N, C)
    for a, wv in zip(got, want):
        assert _rel(a.numpy(), wv) < 1e-5


# ------------------------------------------------------------------- remat

@pytest.mark.parametrize("which", ["unet", "controlnet"])
def test_remat_matches_no_remat(which):
    torch.manual_seed(0)
    make = {"unet": (unet.UNetSpatioTemporalConditionModel, unet.UNetConfig),
            "controlnet": (controlnet.ControlNetModel, controlnet.ControlNetConfig)}[which]
    plain = make[0](make[1].nano())
    remat = make[0](make[1].nano(remat=True))
    remat.load_state_dict(plain.state_dict())
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(rng.randn(B, F, 8, 16, 8).astype(np.float32)), torch.tensor(0.3),
            torch.from_numpy(rng.randn(B, 5, CTX).astype(np.float32)),
            torch.tensor([[6.0, 127.0, 0.02]] * B)]
    if which == "controlnet":
        args.append(torch.from_numpy(rng.randn(B, F, 8, 16, 4).astype(np.float32)))

    def run(model):
        out = model(*args, context_clips=B)
        flat = torch.cat([o.reshape(-1) for o in (out[0] + (out[1],) if which == "controlnet"
                                                   else (out,))])
        grads = torch.autograd.grad((flat * torch.linspace(-1, 1, flat.numel())).sum(),
                                    list(model.parameters()))
        return flat.detach(), grads

    (o1, g1), (o2, g2) = run(plain), run(remat)
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_controlnet_from_unet_matches_jax():
    lat = np.zeros((B, F, H // 8, W // 8, 8), np.float32)
    ctx, ids = np.zeros((B, 5, CTX), np.float32), np.zeros((B, 3), np.float32)
    up = jax_params(junet.UNetSpatioTemporalConditionModel(junet.UNetConfig.nano()), lat, 0.5,
                    ctx, ids, seed=30)
    cp = jax_params(jcn.ControlNetModel(jcn.ControlNetConfig.nano()), lat, 0.5, ctx, ids,
                    lat[..., :4], seed=31)
    want = flax_params_to_torch(controlnet_params_from_unet(up, cp))
    tu = port(unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.nano()), up)
    tc = port(controlnet.ControlNetModel(controlnet.ControlNetConfig.nano()), cp)
    got = controlnet_from_unet(tu, tc).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.reshape(got[k].shape), err_msg=k)


# ----------------------------------------------------- checkpoints and loop

def test_checkpoint_save_restore_and_rotation(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(300, 7)
    tx = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-2, lr_warmup_steps=0,
                                                    use_8bit_adam=True))
    state = trainer.init_train_state(model, tx)
    for step in (1, 2, 3):
        grads = {k: torch.randn_like(p) for k, p in state.params.items()}
        upd, opt = tx.update(grads, state.opt_state, {k: p.detach() for k, p in
                                                       state.params.items()})
        optimizers.apply_updates(state.params, upd)
        state = trainer.TrainState(step, state.params, opt)
        ckpt.save_checkpoint(str(tmp_path), step, state, total_limit=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-3"]
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert ckpt.checkpoint_step(latest) == 3
    fresh = torch.nn.Linear(300, 7)
    restored = ckpt.restore_checkpoint(latest, trainer.init_train_state(fresh, tx))
    assert restored.step == 3
    for k, p in fresh.named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[k])
    adam, adam_r = state.opt_state[0], restored.opt_state[0]
    assert adam_r.count == adam.count == 3
    for k in adam.mu:
        assert torch.equal(adam_r.mu[k].q, adam.mu[k].q)
        assert torch.equal(adam_r.nu[k].scale, adam.nu[k].scale)


def _write_cfg(tmp_path, **over):
    cfg = dict(video_seq_length=3, height=64, width=128, train_batch_size=1,
               num_train_iters=2, checkpointing_steps=1, checkpoints_total_limit=2,
               learning_rate=1e-4, lr_warmup_steps=1, seed=42, use_8bit_adam=True,
               output_dir=str(tmp_path / "out"), use_text=True, motion_bucket_id=200)
    cfg.update(over)
    import yaml

    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def test_train_loop_runs_and_resumes_latest(tmp_path):
    args = ["--mode", "vgl", "--nano", "--synthetic", "2", "--device", "cpu"]
    state = train_loop.main(["--config", _write_cfg(tmp_path), "--max-steps", "2"] + args)
    out = tmp_path / "out"
    assert state.step == 2
    assert sorted(n for n in os.listdir(out) if n.startswith("checkpoint")) == [
        "checkpoint-1", "checkpoint-2"]
    metrics = [json.loads(line) for line in open(out / "logging" / "metrics.jsonl")]
    assert metrics and all(np.isfinite(m["loss"]) for m in metrics)
    state = train_loop.main(["--config", _write_cfg(tmp_path, resume_from_checkpoint="latest"),
                             "--max-steps", "3"] + args)
    assert state.step == 3 and "checkpoint-3" in os.listdir(out)
    assert "checkpoint-1" not in os.listdir(out)  # rotated to the newest two


def test_train_loop_vl_mode(tmp_path):
    state = train_loop.main(["--config", _write_cfg(tmp_path), "--mode", "vl", "--nano",
                             "--synthetic", "2", "--device", "cpu", "--max-steps", "1"])
    assert state.step == 1 and "conv_in.weight" in state.params
    assert os.listdir(tmp_path / "out" / "checkpoint-1") == ["state.pt"]


def test_train_loop_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_loop.main(["--config", _write_cfg(tmp_path), "--nano", "--synthetic", "2"])


def test_config_readers_take_the_shipped_yamls():
    cfg_dir = os.path.join(REPO, "config")
    vgl = train_loop.load_config(os.path.join(cfg_dir, "train_image2video_gesturenet.yaml"))
    tcfg = train_loop.train_config_from_yaml(vgl, "vgl")
    assert tcfg.use_8bit_adam and tcfg.max_grad_norm == 1.0 and tcfg.lr_warmup_steps == 500
    assert tcfg.learning_rate == 5e-6
    assert train_loop.frozen_dtype_from_yaml(vgl) == torch.bfloat16
    vl = train_loop.train_config_from_yaml(
        train_loop.load_config(os.path.join(cfg_dir, "train_image2video.yaml")), "vl")
    assert vl.use_8bit_adam and vl.max_grad_norm is None and vl.learning_rate == 1e-5
    dcfg = train_loop.data_config_from_yaml(vgl)
    assert (dcfg.video_seq_length, dcfg.height, dcfg.width) == (14, 256, 384)
    assert dcfg.dataset_path == () and dcfg.motion_bucket_id == 200
    assert (dcfg.dataset_motion_mean, dcfg.svd_motion_std, dcfg.flip_aug_prob) == (25, 30, 0.45)
