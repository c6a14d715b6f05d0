"""Shared set-up of the train-step parity tests (test_torch_training*.py).

Nano size: 2-block UNet / GestureNet, tiny VAE and CLIP towers, B=2 clips of
3 frames at 64x128, fp32 frozen towers, 8-bit AdamW, no warmup, lr 1e-5.
Both packages load one parameter tree (the JAX modules' init with seeded
numpy values, carried by ``weights/convert``) and take the random draws of
the same JAX key.  A test module builds the towers once (``build_towers``)
and shares them across its setups.

How each side runs, the cheapest way that runs the same code (times on the
CPU beside a running six-worker test suite):

* the JAX loss: ``jax.jit(jax.value_and_grad(loss_fn))``, one trace and
  compile per configuration (~40 s); run eagerly its first call takes
  ~100 s, every primitive compiling on its own;
* the JAX optimizer update: eager (~25 s the first call, ~4 s after),
  against ~80 s to compile it under ``jit`` and ~30 s under
  ``jax.disable_jit()``;
* the port's step: on one torch thread (``torch_one_thread``, autouse in
  the test modules); multi-threaded beside the other workers a step took
  ~30x as long.

Tolerances: step-1 loss rtol 1e-5 and grad_norm rtol 1e-4; per-leaf gradient
relative L2 <= 1e-4 (leaves whose gradient is mathematically zero, a bias
that a one-channel GroupNorm group removes, must be rounding noise on both
sides); step-1 parameters atol 1e-6 where |g| > 1e-6 (below that Adam's
first step g / (|g| + eps) sits on its eps threshold, where gradient
rounding moves it by up to its bound 1, so there the check is |dp| <= 2 lr);
3-step losses rtol 1e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from this_and_that_vdm_tpu.models import clip as jclip
from this_and_that_vdm_tpu.models import controlnet as jcn
from this_and_that_vdm_tpu.models import unet as junet
from this_and_that_vdm_tpu.models import vae as jvae
from this_and_that_vdm_tpu.training import optimizers as jopt
from this_and_that_vdm_tpu.training import trainer as jtrainer

from this_and_that_vdm_tpu_torch.models import clip, controlnet, unet, vae
from this_and_that_vdm_tpu_torch.training import optimizers, trainer
from this_and_that_vdm_tpu_torch.weights.convert import (_diffusers_leaf,
                                                         flax_adam8bit_state_to_torch,
                                                         flax_params_to_torch)

from test_torch_models import jax_params, port

B, F, H, W = 2, 3, 64, 128
CTX = 48
LR = 1e-5
VIS = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, patch_size=56,
           image_size=224, projection_dim=CTX)
TXT = dict(vocab_size=64, hidden_size=CTX, num_layers=1, num_heads=4, intermediate_size=64,
           max_positions=16)


def closure(fn):
    """The free variables of a jitted JAX step (its ``loss_fn`` and ``tx``)."""
    f = fn.__wrapped__
    return dict(zip(f.__code__.co_freevars, (c.cell_contents for c in f.__closure__)))


def draws(key, mask=False):
    """The JAX step's random draws for ``key``, as numpy."""
    k_sig, k_eps, k_aug, k_drop = jax.random.split(key, 4)
    d = dict(sigma=jax.random.normal(k_sig, (B,), jnp.float32),
             noise=jax.random.normal(k_eps, (B, F, H // 8, W // 8, 4)),
             aug=jax.random.normal(k_aug, (B, H, W, 3)),
             dropout=jax.random.uniform(k_drop, (B,)))
    if mask:
        d["mask"] = jax.random.uniform(jax.random.fold_in(key, 17), (B, F, H // 8, W // 8, 1))
    return {k: np.array(v) for k, v in d.items()}  # writable copies for torch


def batch(seed, gesture):
    rng = np.random.RandomState(seed)
    b = dict(video_frames=(rng.randn(B, F, H, W, 3) * 0.2).astype(np.float32),
             prompt_ids=rng.randint(0, 63, (B, 16)).astype(np.int32),
             motion_bucket_id=np.full((B,), 200.0, np.float32))
    if gesture:
        b["condition"] = rng.rand(B, F, H, W, 3).astype(np.float32)
    return b


def nano_params(unet_seed, controlnet_seed):
    """The nano JAX UNet and GestureNet with their seeded parameter trees."""
    lat = np.zeros((B, F, H // 8, W // 8, 8), np.float32)
    ctx, ids = np.zeros((B, 5, CTX), np.float32), np.zeros((B, 3), np.float32)
    ju = junet.UNetSpatioTemporalConditionModel(junet.UNetConfig.nano())
    jc = jcn.ControlNetModel(jcn.ControlNetConfig.nano())
    return (ju, jc, jax_params(ju, lat, 0.5, ctx, ids, seed=unet_seed),
            jax_params(jc, lat, 0.5, ctx, ids, lat[..., :4], seed=controlnet_seed))


def build_towers():
    """The JAX modules, their seeded parameter trees, the ported frozen towers."""
    lat = np.zeros((B, F, H // 8, W // 8, 8), np.float32)
    jm = dict(vae=jvae.AutoencoderKLTemporalDecoder(jvae.VAEConfig.tiny()),
              image_encoder=jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**VIS)),
              text_encoder=jclip.CLIPTextModel(jclip.CLIPTextConfig(**TXT)))
    ju, jc, unet_params, controlnet_params = nano_params(23, 24)
    params = dict(
        vae=jax_params(jm["vae"], np.zeros((1, H, W, 3), np.float32), lat[:1, :2, ..., :4],
                       seed=20),
        image_encoder=jax_params(jm["image_encoder"], np.zeros((1, 224, 224, 3), np.float32),
                                 seed=21),
        text_encoder=jax_params(jm["text_encoder"], np.zeros((1, 16), np.int32), seed=22),
        unet=unet_params, controlnet=controlnet_params)
    tm = dict(vae=port(vae.AutoencoderKLTemporalDecoder(vae.VAEConfig.tiny()), params["vae"]),
              image_encoder=port(clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(**VIS)),
                                 params["image_encoder"]),
              text_encoder=port(clip.CLIPTextModel(clip.CLIPTextConfig(**TXT)),
                                params["text_encoder"]))
    for m in tm.values():
        m.requires_grad_(False)
    return dict(jm=jm, ju=ju, jc=jc, params=params, tm=tm)


class Setup:
    """JAX and port models on one parameter tree, with each package's step."""

    def __init__(self, towers, mode, **cfg_kw):
        p, jm, tm = towers["params"], towers["jm"], towers["tm"]
        self.mode = mode
        self.frozen = {k: p[k] for k in ("vae", "image_encoder", "text_encoder")}
        self.tunet = port(unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.nano()), p["unet"])
        cfg = dict(learning_rate=LR, lr_warmup_steps=0, use_8bit_adam=True, **cfg_kw)
        if mode == "vgl":
            cfg["max_grad_norm"] = 1.0
        jcfg, tcfg = jtrainer.TrainConfig(**cfg), trainer.TrainConfig(**cfg)
        self.jtx = jtrainer.make_optimizer(jcfg)
        if mode == "vl":
            self.params = p["unet"]
            jstep = jtrainer.make_vl_train_step(towers["ju"], jm, self.jtx, jcfg)
            self.model = self.tunet.train()
        else:
            self.params = p["controlnet"]
            self.frozen["unet"] = p["unet"]
            self.tunet.requires_grad_(False)
            jstep = jtrainer.make_vgl_train_step(towers["ju"], towers["jc"], jm, self.jtx, jcfg)
            self.model = port(controlnet.ControlNetModel(controlnet.ControlNetConfig.nano()),
                              self.params).train()
        self.jloss = jax.jit(jax.value_and_grad(closure(jstep)["loss_fn"]))
        ttx = trainer.make_optimizer(tcfg, dict(self.model.named_parameters()))
        self.tstate = trainer.init_train_state(self.model, ttx)
        if mode == "vl":
            self.tstep = trainer.make_vl_train_step(self.tunet, tm, ttx, tcfg)
        else:
            self.tstep = trainer.make_vgl_train_step(self.tunet, self.model, tm, ttx, tcfg)
        self.jopt_state = self.jtx.init(self.params)

    def jax_step(self, batch, key, update=True):
        loss, grads = self.jloss(self.params, self.frozen, batch, key)
        if update:
            updates, self.jopt_state = self.jtx.update(grads, self.jopt_state, self.params)
            self.params = optax.apply_updates(self.params, updates)
        return float(loss), float(optax.global_norm(grads)), grads

    def torch_step(self, batch, draws):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        self.tstate, m = self.tstep(self.tstate, tb, draws=draws)
        return float(m["loss"]), float(m["grad_norm"])


def run(setup, steps):
    """Both packages over ``steps`` steps -> (per-step (jax loss, jax
    grad_norm, port loss, port grad_norm), first-step details)."""
    gesture = setup.mode == "vgl"
    out = []
    for i in range(steps):
        b, key = batch(i, gesture), jax.random.PRNGKey(100 + i)
        d = draws(key)
        if i == 0:  # the port's own gradients at the initial parameters
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            loss = setup.tstep.loss_fn(tb, None, d)
            tgrads = dict(zip(setup.tstate.params,
                              torch.autograd.grad(loss, list(setup.tstate.params.values()))))
        jl, jg, jgrads = setup.jax_step({k: jnp.asarray(v) for k, v in b.items()}, key,
                                        update=i < steps - 1)
        tl, tg = setup.torch_step(b, d)
        out.append((jl, jg, tl, tg))
        if i == 0:
            first = dict(jgrads=flax_params_to_torch(jax.device_get(jgrads)), tgrads=tgrads,
                         jparams=flax_params_to_torch(jax.device_get(setup.params)),
                         tparams={k: p.detach().numpy().copy()
                                  for k, p in setup.tstate.params.items()})
    return out, first


def trained(mode, towers):
    """A 3-step run of ``mode``, with the UNet's state before it."""
    setup = Setup(towers, mode)
    unet_before = {k: v.clone() for k, v in setup.tunet.state_dict().items()}
    out, first = run(setup, 3)
    return setup, out, first, unet_before


# ------------------------------------------------------------------ checks

def check_step_one(setup, out, first):
    jl, jg, tl, tg = out[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    jgrads, tgrads = first["jgrads"], first["tgrads"]
    assert set(jgrads) == set(tgrads)
    floor = 1e-5 * jg
    for k, want in jgrads.items():
        got = tgrads[k].numpy()
        want = want.reshape(got.shape)
        if np.linalg.norm(want) > floor:
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), k
        else:
            assert np.linalg.norm(got) <= floor, k
    for k, want in first["jparams"].items():
        got = first["tparams"][k]
        want = want.reshape(got.shape)
        big = np.abs(jgrads[k].reshape(got.shape)) > 1e-6
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6, err_msg=k)
        assert np.all(np.abs(got - want)[~big] <= 2 * LR * (1 + 1e-3)), k


def check_three_losses(out):
    for jl, jg, tl, tg in out:
        assert np.isfinite([jl, jg, tl, tg]).all()
        np.testing.assert_allclose(tl, jl, rtol=1e-3)


def adam_state(opt_state, mode):
    """The Adam8bitState inside the optimizer chain (VGL chains the clip first)."""
    return opt_state[1][0] if mode == "vgl" else opt_state[0]


def check_trainable_only(setup, unet_before):
    after = setup.tunet.state_dict()
    unchanged = all(torch.equal(after[k], v) for k, v in unet_before.items())
    assert unchanged == (setup.mode == "vgl")  # the VGL UNet is frozen bit for bit
    adam = adam_state(setup.tstate.opt_state, setup.mode)
    names = dict(setup.model.named_parameters())
    assert set(adam.mu) == set(names) and adam.count == 3  # the 8-bit state covers the tree
    assert all(adam.mu[k].q.numel() >= p.numel() for k, p in names.items())


def _leaves(tree, ptree, path=()):
    for k, v in ptree.items():
        if isinstance(v, dict):
            yield from _leaves(tree[k], v, path + (k,))
        else:
            yield path, k, v, tree[k]


def check_state_converter(setup):
    """The JAX state after 2 updates, carried into the port's layout: 1-D
    leaves bit for bit, the others within the log codebook's round trip
    (8% relative on magnitudes above 1e-6 of the block's largest)."""
    jadam = jax.device_get(adam_state(setup.jopt_state, setup.mode))
    params = jax.device_get(setup.params)
    conv = flax_adam8bit_state_to_torch(jadam, params)
    assert conv.count == 2
    names = dict(setup.model.named_parameters())
    assert set(conv.mu) == set(names)
    for tree, out, signed in ((jadam.mu, conv.mu, True), (jadam.nu, conv.nu, False)):
        for path, name, p, jq in _leaves(tree["params"], params["params"]):
            deq = np.asarray(jopt._dequantize(jq, p.shape, signed))
            key, want = _diffusers_leaf(path, name, deq)
            q = out[key]
            if names[key].dim() == 1:
                np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
                np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
            got = optimizers._dequantize(q, tuple(names[key].shape), signed).numpy()
            want = np.asarray(want).reshape(got.shape)
            big = np.abs(want) > 1e-6 * max(np.abs(want).max(), 1e-30)
            assert np.all(np.abs(got - want)[big] <= 0.08 * np.abs(want)[big]), key
