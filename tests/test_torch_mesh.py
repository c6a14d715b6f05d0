"""The port's ``parallel/mesh.py`` in one process: the mesh builders (as
``tests/test_multihost.py`` holds the JAX ones), the block rows of the
8-bit optimizer's arena, the CFG-branch rows of the temporal
cross-attention, and the serving mesh: the pipelines and the server on a
(clip, cfg) mesh of CPU devices against one device and against the JAX
pipelines (nano models, 2 frames, latent output; the tolerances of
``tests/test_serving_mesh.py``: VL at clip 2 x cfg 2 5e-4, VGL at clip 1 x
cfg 2 3e-4, guess mode included)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.models import clip as jclip
from this_and_that_vdm_tpu.models import controlnet as jcn
from this_and_that_vdm_tpu.models import unet as junet
from this_and_that_vdm_tpu.models import vae as jvae
from this_and_that_vdm_tpu.pipelines import (
    StableVideoDiffusionControlNetPipeline as JaxVGL, StableVideoDiffusionPipeline as JaxVL)

from this_and_that_vdm_tpu_torch import parallel
from this_and_that_vdm_tpu_torch.models import clip, controlnet, unet, vae
from this_and_that_vdm_tpu_torch.models.layers import LayerNorm
from this_and_that_vdm_tpu_torch.models.transformer import CfgBranch, GroupedCrossAttention
from this_and_that_vdm_tpu_torch.ops import adam8bit as k4
from this_and_that_vdm_tpu_torch.parallel import mesh as mesh_mod
from this_and_that_vdm_tpu_torch.pipelines import (
    StableVideoDiffusionControlNetPipeline, StableVideoDiffusionPipeline)
from this_and_that_vdm_tpu_torch.serving import VideoGenServer

from test_torch_models import jax_params, port
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

B, FR, H, W = 2, 2, 64, 128
CTX = 48
CPU4 = ["cpu"] * 4


# ------------------------------------------------------------------ meshes

def test_make_mesh_dcn_axis_keeps_slices_contiguous():
    mesh = parallel.make_mesh(list(range(8)), dp=2, fsdp=2, dcn=2)
    assert mesh.axis_names == ("dcn", "dp", "fsdp")
    assert mesh.shape == {"dcn": 2, "dp": 2, "fsdp": 2}
    assert list(mesh.devices[0].ravel()) == [0, 1, 2, 3]
    assert list(mesh.devices[1].ravel()) == [4, 5, 6, 7]
    # fsdp innermost: an fsdp group is a run of consecutive ranks
    assert [mesh.coords(r)["fsdp"] for r in range(4)] == [0, 1, 0, 1]
    assert mesh.coords(6) == {"dcn": 1, "dp": 1, "fsdp": 0}
    with pytest.raises(AssertionError):
        parallel.make_mesh(list(range(8)), dp=3, fsdp=2)


def test_make_mesh_default_has_no_dcn_axis_and_one_rank_without_a_group():
    assert parallel.make_mesh(list(range(4)), fsdp=2).axis_names == ("dp", "fsdp")
    mesh = parallel.make_mesh()
    assert mesh.shape == {"dp": 1, "fsdp": 1} and mesh.group("fsdp") is None


def test_shard_batch_takes_the_rank_rows_and_raises_on_nondivisible():
    mesh = parallel.make_mesh(list(range(4)), fsdp=2)
    x = np.arange(8 * 3).reshape(8, 3)
    got = parallel.shard_batch({"x": x, "s": np.float32(1.0)}, mesh, rank=3)
    np.testing.assert_array_equal(got["x"], x[6:8])
    assert got["s"] == 1.0  # scalars are kept
    with pytest.raises(ValueError, match="divisible"):
        parallel.shard_batch({"x": np.zeros((3, 5))}, mesh, rank=0)


def test_global_batch_single_process_and_rejects_mixed_leading_dims(monkeypatch):
    mesh = parallel.make_mesh()
    out = parallel.global_batch({"x": np.arange(6.0).reshape(2, 3), "s": np.float32(7)}, mesh)
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(6.0).reshape(2, 3))
    assert float(out["s"]) == 7.0
    monkeypatch.setattr(mesh_mod, "_world", lambda: 2)
    with pytest.raises(ValueError, match="batch-collated"):
        parallel.global_batch({"x": np.zeros((4, 3)), "bias": np.zeros(7)}, mesh)


def test_serving_mesh_shapes():
    m = parallel.make_serving_mesh(["cpu"] * 8, cfg=2)
    assert m.shape == {"clip": 4, "cfg": 2} and m.axis_names == ("clip", "cfg")
    with pytest.raises(AssertionError):
        parallel.make_serving_mesh(["cpu"] * 8, cfg=3)
    chunks = parallel.shard_leading(torch.arange(3), m, ("clip",))
    assert [c.tolist() for c in chunks] == [[0], [1], [2], []]


# ------------------------------------------------------- block rows (fsdp)

def test_block_rows_cover_the_arena_and_pack_round_trips():
    rng = np.random.RandomState(0)
    params = {n: torch.from_numpy(rng.randn(*s).astype(np.float32))
              for n, s in (("a", (300,)), ("b", (16, 16)), ("c", (10,)), ("d", (10, 100)),
                           ("e", (7, 3, 3)))}
    first, total = k4.leaf_blocks([p.numel() for p in params.values()])
    seen = {k: 0 for k in params}
    for part in range(3):
        rows = parallel.shard_params(params, parallel.make_mesh(list(range(3)), fsdp=3),
                                     rank=part)
        assert rows.rows == -(-total // 3) and rows.lo == part * rows.rows
        buf = rows.pack(params)
        assert buf.numel() == 3 * rows.rows * 256
        mine = buf[rows.lo * 256:(rows.lo + rows.rows) * 256]
        for k, v in rows.views(mine).items():
            e0, e1 = rows.pieces[k]
            assert e0 % 256 == 0  # a piece starts on a block of its leaf
            assert torch.equal(v, params[k].reshape(-1)[e0:e1])
            seen[k] += e1 - e0
        for i, k in enumerate(rows.names):  # every leaf whole in the buffer of all parts
            s = rows.first[i] * 256
            assert torch.equal(buf[s:s + rows.numels[i]].view(rows.shapes[i]), params[k])
    assert all(seen[k] == p.numel() for k, p in params.items())


def test_adam8bit_over_row_ranges_equals_the_whole_update():
    """K4's plain version over two ranges of arena rows (cut inside a leaf)
    gives those rows of the update over whole leaves, bit for bit."""
    rng = np.random.RandomState(1)
    numels = [513, 256 * 3, 40, 256 * 5 + 7]
    first, total = k4.leaf_blocks(numels)
    gs = [torch.from_numpy(rng.randn(n).astype(np.float32) * 1e-3) for n in numels]
    nbs = [-(-n // 256) for n in numels]
    mqs = [torch.from_numpy(rng.randint(0, 255, nb * 256).astype(np.uint8)) for nb in nbs]
    nqs = [torch.from_numpy(rng.randint(0, 256, nb * 256).astype(np.uint8)) for nb in nbs]
    mss = [torch.from_numpy(rng.rand(nb).astype(np.float32) * 1e-3) for nb in nbs]
    nss = [torch.from_numpy(rng.rand(nb).astype(np.float32) * 1e-6) for nb in nbs]
    bc = k4.bias_corrections(7, 0.9, 0.999)
    whole = k4.adam8bit_leaves(gs, mqs, mss, nqs, nss, bc)
    covered = 0
    for lo, hi in ((0, 5), (5, total)):
        parts, got = k4.adam8bit_rows(gs, mqs, mss, nqs, nss, bc, (lo, hi))
        for j, (i, e0, e1) in enumerate(parts):
            b0, b1 = e0 // 256, -(-e1 // 256)
            want = (whole[0][i][e0:e1], whole[1][i][b0 * 256:b1 * 256], whole[2][i][b0:b1],
                    whole[3][i][b0 * 256:b1 * 256], whole[4][i][b0:b1])
            for k in range(5):
                assert torch.equal(got[k][j], want[k]), (lo, i, k)
            covered += e1 - e0
    assert covered == sum(numels)


def test_cfg_branch_rows_meet_the_contexts_of_the_whole_batch():
    torch.manual_seed(0)
    attn, ln = GroupedCrossAttention(32, 4, 8, 24), LayerNorm(32)
    for count, clips, s in ((2, 2, 6), (3, 1, 5), (2, 1, 7), (3, 2, 4)):
        b = count * clips
        x, ctx = torch.randn(b * s, 3, 32), torch.randn(b, 5, 24)
        full = attn(x, ctx, ln, clips)
        rows = clips * s
        got = torch.cat([attn(x[j * rows:(j + 1) * rows], ctx[j * clips:(j + 1) * clips], ln,
                              CfgBranch(clips, j, count, ctx)) for j in range(count)])
        torch.testing.assert_close(got, full, rtol=0, atol=1e-6)


# ------------------------------------------------------------ serving mesh

VIS = dict(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, patch_size=56,
           image_size=224, projection_dim=CTX)
TXT = dict(vocab_size=64, hidden_size=CTX, num_layers=1, num_heads=4, intermediate_size=64,
           max_positions=16)


@pytest.fixture(scope="module")
def pipes():
    """(JAX VGL pipeline, the port's five models) on one parameter tree."""
    lat = np.zeros((B, FR, H // 8, W // 8, 8), np.float32)
    ctx = np.zeros((B, 5, CTX), np.float32)
    ids = np.zeros((B, 3), np.float32)
    j = dict(unet=junet.UNetSpatioTemporalConditionModel(junet.UNetConfig.nano()),
             controlnet=jcn.ControlNetModel(jcn.ControlNetConfig.nano()),
             vae=jvae.AutoencoderKLTemporalDecoder(jvae.VAEConfig.tiny()),
             image_encoder=jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**VIS)),
             text_encoder=jclip.CLIPTextModel(jclip.CLIPTextConfig(**TXT)))
    p = dict(unet=jax_params(j["unet"], lat, 0.5, ctx, ids, seed=30),
             controlnet=jax_params(j["controlnet"], lat, 0.5, ctx, ids, lat[..., :4], seed=31),
             vae=jax_params(j["vae"], np.zeros((1, H, W, 3), np.float32), lat[:1, :2, ..., :4],
                            seed=32),
             image_encoder=jax_params(j["image_encoder"], np.zeros((1, 224, 224, 3), np.float32),
                                      seed=33),
             text_encoder=jax_params(j["text_encoder"], np.zeros((1, 16), np.int32), seed=34))
    jax_pipe = JaxVGL(unet=j["unet"], vae=j["vae"], image_encoder=j["image_encoder"],
                      text_encoder=j["text_encoder"], controlnet=j["controlnet"],
                      unet_params=p["unet"], vae_params=p["vae"],
                      image_encoder_params=p["image_encoder"],
                      text_encoder_params=p["text_encoder"], controlnet_params=p["controlnet"])
    t = dict(unet=port(unet.UNetSpatioTemporalConditionModel(unet.UNetConfig.nano()), p["unet"]),
             controlnet=port(controlnet.ControlNetModel(controlnet.ControlNetConfig.nano()),
                             p["controlnet"]),
             vae=port(vae.AutoencoderKLTemporalDecoder(vae.VAEConfig.tiny()), p["vae"]),
             image_encoder=port(clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(**VIS)),
                                p["image_encoder"]),
             text_encoder=port(clip.CLIPTextModel(clip.CLIPTextConfig(**TXT)),
                               p["text_encoder"]))
    for m in t.values():
        m.requires_grad_(False)
    return jax_pipe, t


def _inputs():
    rng = np.random.RandomState(0)
    image = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    ids = rng.randint(0, 63, (B, 16))
    cond = rng.uniform(0, 1, (FR, H, W, 3)).astype(np.float32)
    latents = rng.randn(B, FR, H // 8, W // 8, 4).astype(np.float32)
    return image, ids, cond, latents


def _kw(steps, **extra):
    image, ids, cond, latents = _inputs()
    return dict(prompt_ids=ids, num_frames=FR, num_inference_steps=steps,
                noise_aug_strength=0.0, latents=latents, output_type="latent", **extra)


def _vl(t):
    return StableVideoDiffusionPipeline(t["unet"], t["vae"], t["image_encoder"],
                                        t["text_encoder"])


def _vgl(t):
    return StableVideoDiffusionControlNetPipeline(t["unet"], t["vae"], t["image_encoder"],
                                                  t["controlnet"], t["text_encoder"])


def test_vl_clip2_cfg2_mesh_matches_one_device_and_jax(pipes):
    jax_pipe, t = pipes
    image = _inputs()[0]
    ref = _vl(t)(image, **_kw(2))
    got = _vl(t).place_on_mesh(parallel.make_serving_mesh(CPU4, cfg=2))(image, **_kw(2))
    np.testing.assert_allclose(got, ref, atol=5e-4)
    jvl = JaxVL(unet=jax_pipe.unet, vae=jax_pipe.vae, image_encoder=jax_pipe.image_encoder,
                text_encoder=jax_pipe.text_encoder, unet_params=jax_pipe.unet_params,
                vae_params=jax_pipe.vae_params,
                image_encoder_params=jax_pipe.image_encoder_params,
                text_encoder_params=jax_pipe.text_encoder_params)
    kw = _kw(2)
    kw["latents"] = jnp.asarray(kw["latents"])
    want = np.asarray(jvl(image, key=jax.random.PRNGKey(1), **kw))
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("guess", [False, True], ids=["standard", "guess"])
def test_vgl_clip1_cfg2_mesh_matches_one_device_and_jax(pipes, guess):
    jax_pipe, t = pipes
    image, _, cond, _ = _inputs()
    ref = _vgl(t)(image, cond, **_kw(1, guess_mode=guess))
    mesh = parallel.make_serving_mesh(["cpu"] * 2, cfg=2)
    got = _vgl(t).place_on_mesh(mesh)(image, cond, **_kw(1, guess_mode=guess))
    np.testing.assert_allclose(got, ref, atol=3e-4)
    kw = _kw(1, guess_mode=guess)
    kw["latents"] = jnp.asarray(kw["latents"])
    want = np.asarray(jax_pipe(image, cond, key=jax.random.PRNGKey(1), **kw))
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_ip2p_cfg3_mesh_routes_the_guess_mode_controlnet(pipes):
    """ip2p's three branches on three devices, guess mode: the ControlNet
    runs on the conditional branch (first in the ip2p layout) alone."""
    _, t = pipes
    image, _, cond, _ = _inputs()
    kw = _kw(1, guess_mode=True, use_instructpix2pix=True)
    ref = _vgl(t)(image, cond, **kw)
    calls = []
    mesh_pipe = _vgl(t).place_on_mesh(parallel.make_serving_mesh(["cpu"] * 3, cfg=3))
    cn = mesh_pipe._replicas[torch.device("cpu")].controlnet
    hook = cn.register_forward_hook(lambda m, a, o: calls.append(a[0].shape[0]))
    try:
        got = mesh_pipe(image, cond, **kw)
    finally:
        hook.remove()
    np.testing.assert_allclose(got, ref, atol=3e-4)
    assert calls == [B]  # one ControlNet call, over the conditional branch's rows


def test_server_on_a_clip_mesh_batches_and_each_clip_equals_it_served_alone(pipes):
    _, t = pipes
    image, ids, cond, _ = _inputs()
    sampling = dict(num_frames=FR, num_inference_steps=1, noise_aug_strength=0.0,
                    output_type="latent")
    with VideoGenServer(_vgl(t), **sampling) as server:
        assert server.max_batch == 1
        alone = [server.submit(image[i], condition=cond, prompt_ids=ids[i], seed=5 + i).result(60)
                 for i in range(2)]
    with VideoGenServer(_vgl(t), mesh=parallel.make_serving_mesh(["cpu"] * 2, cfg=1),
                        max_delay_s=5.0, **sampling) as server:
        assert server.max_batch == 2  # the mesh's clip extent
        futs = [server.submit(image[i], condition=cond, prompt_ids=ids[i], seed=5 + i)
                for i in range(2)]
        got = [f.result(60) for f in futs]
    assert [f.timing["batch"] for f in futs] == [2, 2]
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g, a)
    with VideoGenServer(_vgl(t), mesh=parallel.make_serving_mesh(["cpu"] * 2, cfg=2)) as server:
        assert server.max_batch == 1
