"""The port's SAM (``models/sam.py``) against the JAX module, on the CPU.

A ``sam_vit_*.pth``-layout state dict is made from a numpy seed with the
port module's own names and shapes; it reaches JAX through
``sam_state_dict_to_flax`` and the port through ``load_state_dict(strict=
True)``.  Masks and IoU predictions agree within 2e-4 * max(scale, 1) (the
bound of the JAX package's own ``tests/test_sam.py``) for point, box and
padding prompts and for the mask-prompt path; the weight round trip is
bit-equal; the PIL-free resize equals PIL's; the antialiased mask upscale
is within 1e-5 of ``jax.image.resize``; the native wrapper pads prompts,
caches embeddings and thresholds masks as the JAX one does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from this_and_that_vdm_tpu.curation import detectors as jdet
from this_and_that_vdm_tpu.models import sam as jsam
from this_and_that_vdm_tpu.weights.convert import sam_state_dict_to_flax

from this_and_that_vdm_tpu_torch.curation import detectors
from this_and_that_vdm_tpu_torch.data.image import resize_bilinear_pil
from this_and_that_vdm_tpu_torch.models import sam
from this_and_that_vdm_tpu_torch.weights.convert import flax_sam_params_to_torch

from torch_one_thread import one_torch_thread  # noqa: F401

CFG = sam.SamConfig.tiny()
JCFG = jsam.SamConfig.tiny()


def official_state_dict(module: torch.nn.Module, seed: int = 0, scale: float = 0.08):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            for k, v in module.state_dict().items()}


def bound(want):
    return 2e-4 * max(float(np.abs(want).max()), 1.0)


@pytest.fixture(scope="module")
def pair():
    model = sam.Sam(CFG).eval()
    sd = official_state_dict(model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    params = sam_state_dict_to_flax(sd)
    return sd, params, model


@pytest.fixture(scope="module")
def jax_fns():
    m = jsam.Sam(JCFG)
    return (jax.jit(lambda p, x: m.apply(p, x, method=jsam.Sam.encode_image)),
            jax.jit(lambda p, e, pts, lbl, mk: m.apply(p, e, pts, lbl, mk,
                                                        method=jsam.Sam.predict)),
            jax.jit(lambda p, e, pts, lbl: m.apply(p, e, pts, lbl, method=jsam.Sam.predict)))


# prompt set 0: positive + negative + padding; set 1: box corners + padding
POINTS = np.array([[[10.5, 20.5], [40.5, 5.5], [0.0, 0.0]],
                   [[8.5, 8.5], [50.5, 40.5], [0.0, 0.0]]], np.float32)
LABELS = np.array([[1, 0, -1], [2, 3, -1]], np.int64)


def test_encode_and_predict_match_jax(pair, jax_fns):
    _, params, model = pair
    enc, _, pred = jax_fns
    img = np.random.RandomState(0).randn(1, CFG.img_size, CFG.img_size, 3).astype(np.float32)
    emb_j = enc(params, jnp.asarray(img))
    masks_j, iou_j = pred(params, emb_j, jnp.asarray(POINTS), jnp.asarray(LABELS, np.int32))
    with torch.no_grad():
        emb = model.encode_image(torch.from_numpy(img))
        masks, iou = model.predict(emb, torch.from_numpy(POINTS), torch.from_numpy(LABELS))
    np.testing.assert_allclose(emb.numpy(), np.asarray(emb_j), atol=bound(emb_j), rtol=0)
    assert masks.shape == (2, CFG.num_mask_tokens, 4 * CFG.grid_size, 4 * CFG.grid_size)
    np.testing.assert_allclose(masks.numpy(), np.asarray(masks_j), atol=bound(masks_j), rtol=0)
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_j), atol=bound(iou_j), rtol=0)


def test_mask_prompt_path_matches_jax(pair, jax_fns):
    _, params, model = pair
    _, pred, _ = jax_fns
    rng = np.random.RandomState(1)
    g4 = 4 * CFG.grid_size
    mask = rng.randn(2, g4, g4, 1).astype(np.float32)
    emb = rng.randn(1, CFG.grid_size, CFG.grid_size, CFG.prompt_embed_dim).astype(np.float32)
    masks_j, iou_j = pred(params, jnp.asarray(emb), jnp.asarray(POINTS),
                          jnp.asarray(LABELS, np.int32), jnp.asarray(mask))
    with torch.no_grad():
        masks, iou = model.predict(torch.from_numpy(emb), torch.from_numpy(POINTS),
                                   torch.from_numpy(LABELS), torch.from_numpy(mask))
    np.testing.assert_allclose(masks.numpy(), np.asarray(masks_j), atol=bound(masks_j), rtol=0)
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_j), atol=bound(iou_j), rtol=0)


def test_weight_round_trip_is_bit_equal(pair):
    sd, params, model = pair
    back = flax_sam_params_to_torch(params)
    assert set(back) == set(sd) == set(model.state_dict())
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k


def test_vit_h_window_grid_pads_to_70():
    """ViT-H's 64-token grid pads to 70 for 14-wide windows (25 windows)."""
    x = torch.arange(64 * 64 * 2, dtype=torch.float32).reshape(1, 64, 64, 2)
    win, padded = sam.window_partition(x, 14)
    assert padded == (70, 70) and win.shape == (25, 14, 14, 2)
    jwin, jpadded = jsam.window_partition(jnp.asarray(x.numpy()), 14)
    assert np.array_equal(win.numpy(), np.asarray(jwin)) and jpadded == padded
    assert torch.equal(sam.window_unpartition(win, 14, padded, (64, 64)), x)


@pytest.mark.parametrize("hw", [(30, 50), (480, 640), (200, 90)])
def test_resize_equals_pil(hw):
    from PIL import Image

    img = (np.random.RandomState(2).rand(*hw, 3) * 255).astype(np.uint8)
    for size in (64, 1024):
        nh, nw = sam._resized_hw(hw, size)
        want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        got = resize_bilinear_pil(img, nh, nw)
        assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1
        assert np.array_equal(got, want)  # bit-equal in practice


def test_preprocess_and_coords_match_jax():
    img = (np.random.RandomState(3).rand(30, 50, 3) * 255).astype(np.uint8)
    x, hw = sam.preprocess_np(img, 64)
    jx, jhw = jsam.preprocess_np(img, 64)
    assert hw == jhw and x.shape == jx.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(x, jx, atol=1e-6, rtol=0)
    pts = np.array([[10.0, 20.0], [49.0, 0.0]])
    np.testing.assert_array_equal(sam.transform_coords_np(pts, (30, 50), 64),
                                  jsam.transform_coords_np(pts, (30, 50), 64))


@pytest.mark.parametrize("low,input_hw,orig_hw,size", [((2, 4, 16, 16), (38, 64), (30, 50), 64),
                                                      ((1, 1, 256, 256), (768, 1024), (480, 640),
                                                       1024)])
def test_postprocess_masks_match_antialiased_jax_resize(low, input_hw, orig_hw, size):
    x = (np.random.RandomState(4).randn(*low) * 8).astype(np.float32)
    got = sam.postprocess_masks_np(x, input_hw, orig_hw, size)
    want = np.asarray(jsam.postprocess_masks_np(x, input_hw, orig_hw, size))
    assert got.shape == want.shape == low[:2] + orig_hw
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if size == 1024:  # a downsample: plain bilinear is not the JAX resize
        import torch.nn.functional as F

        t = F.interpolate(torch.from_numpy(x), (size, size), mode="bilinear")
        plain = F.interpolate(t[:, :, :input_hw[0], :input_hw[1]], orig_hw,
                              mode="bilinear").numpy()
        assert np.abs(plain - want).max() > 1e-3


def test_native_segmenter_matches_jax_wrapper(pair):
    """Point + box, 2 labelled points (8 slots) and 20 labelled points (24
    slots, the trajectory stage's prompt): the same masks as the JAX
    wrapper; one encode a frame; a new frame encodes again."""
    _, params, model = pair
    seg = detectors.NativeSAMSegmenter(model=model, device="cpu")
    jseg = jdet.NativeSAMSegmenter(params=params, model_type="tiny")
    rng = np.random.RandomState(5)
    img = (rng.rand(30, 50, 3) * 255).astype(np.uint8)
    pts20 = rng.rand(20, 2) * [50, 30]
    lbl20 = (rng.rand(20) > 0.3).astype(np.int64)
    cases = [("predict_mask", (img, np.array([[10.0, 15.0]]), np.array([5.0, 5.0, 40.0, 25.0]))),
             ("predict_mask_labeled", (img[..., ::-1].copy(),
                                       np.array([[10.0, 15.0], [30.0, 20.0]]), np.array([1, 0]))),
             ("predict_mask_labeled", (img[..., ::-1].copy(), pts20, lbl20))]
    for name, args in cases:
        got, want = getattr(seg, name)(*args), getattr(jseg, name)(*args)
        assert got.shape == (30, 50) and got.dtype == bool
        assert np.array_equal(got, want), name
    assert seg.encodes == 1  # one frame, three prompts
    seg.predict_mask_labeled(img, pts20[:3], lbl20[:3])
    assert seg.encodes == 2
