"""The port's XMem (``models/xmem.py``) and its memory and inference core
(``curation/xmem_tracker.py``) against the JAX modules, on the CPU.

One ``XMem-s012.pth``-layout state dict is made from a numpy seed with the
port module's own names and shapes; JAX gets it through
``xmem_state_dict_to_flax``, the port through ``load_state_dict(strict=True)``,
and ``flax_xmem_params_to_torch`` gives it back bit for bit.  Frames are
64x48, the JAX tests' size (XMem's widths are fixed).

Tolerances: the network's outputs (encode_key, encode_value, segment,
read_memory) within 1e-4 of each tensor's largest magnitude, ten times
under ``tests/test_xmem.py``'s 7e-4 against its torch oracle; the attention
math (key_similarity, topk_softmax, aggregate) and the memory store's
values within 1e-5, its sizes and ``v_idx`` equal; the inference core's
probabilities of the first frames within 1e-4, then the masks of the whole
clip by IoU >= 0.99 (usage accumulates affinities frame by frame, so a
last-bit difference may flip an eviction frames later).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from this_and_that_vdm_tpu.curation import xmem_tracker as jtrk
from this_and_that_vdm_tpu.models import xmem as jxm
from this_and_that_vdm_tpu.weights.convert import xmem_state_dict_to_flax

from this_and_that_vdm_tpu_torch.curation import xmem_tracker as trk
from this_and_that_vdm_tpu_torch.curation.detectors import _from_state_dict
from this_and_that_vdm_tpu_torch.models import xmem as xm
from this_and_that_vdm_tpu_torch.weights.convert import flax_xmem_params_to_torch

from torch_one_thread import one_torch_thread  # noqa: F401

H, W = 64, 48
NET_TOL = 1e-4   # relative to the largest magnitude of the JAX tensor
MATH_TOL = 1e-5


def seeded_state_dict(module: torch.nn.Module, seed: int = 0):
    """Values from a numpy seed under the module's own names: weights at
    1/sqrt(fan-in), batch norms with nontrivial statistics."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if not v.is_floating_point():
            sd[k] = np.zeros(shape, np.int64)
        elif k.endswith("running_var"):
            sd[k] = (rng.rand(*shape) + 0.5).astype(np.float32)
        elif k.endswith("running_mean"):
            sd[k] = (rng.randn(*shape) * 0.3).astype(np.float32)
        elif len(shape) == 1 and k.endswith("weight"):
            sd[k] = (rng.rand(*shape) + 0.5).astype(np.float32)
        elif len(shape) <= 1:
            sd[k] = (rng.randn(*shape) * 0.1).astype(np.float32)
        else:
            sd[k] = (rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    return sd


def port_xmem(sd):
    return _from_state_dict(xm.XMem, sd).eval()


@pytest.fixture(scope="module")
def nets():
    with torch.device("meta"):
        names = xm.XMem()
    sd = seeded_state_dict(names)
    params = jax.tree.map(jnp.asarray, xmem_state_dict_to_flax(sd))
    return sd, params, port_xmem(sd)


def close(got, want, tol=NET_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-6))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def test_state_dict_round_trip_and_strict_load(nets):
    sd, params, model = nets
    back = flax_xmem_params_to_torch(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and np.array_equal(back[k], sd[k]), k
    assert set(model.state_dict()) == set(sd)  # the published names, strictly


def test_encode_key_matches_jax(nets):
    _, params, model = nets
    frame = np.random.default_rng(0).standard_normal((1, H, W, 3), np.float32)
    m = jxm.XMem()
    want = m.apply(params, jnp.asarray(frame), method=m.encode_key)
    with torch.no_grad():
        got = model.encode_key(torch.from_numpy(frame).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        close(nhwc(g), w)


def test_encode_value_segment_and_read_memory_match_jax(nets):
    _, params, model = nets
    rng = np.random.default_rng(1)
    frame = rng.standard_normal((1, H, W, 3), np.float32)
    masks = (rng.random((1, 2, H, W)) > 0.7).astype(np.float32)
    h16 = rng.standard_normal((1, 2, H // 16, W // 16, 64), np.float32) * 0.3
    readout = rng.standard_normal((1, 2, H // 16, W // 16, 512), np.float32) * 0.2
    m = jxm.XMem()
    _, _, _, f16, f8, f4 = m.apply(params, jnp.asarray(frame), method=m.encode_key)
    v, h = m.apply(params, jnp.asarray(frame), f16, jnp.asarray(h16), jnp.asarray(masks),
                   method=m.encode_value)
    hid, logits, prob = m.apply(params, f16, f8, f4, jnp.asarray(readout), jnp.asarray(h16),
                                True, False, method=m.segment)
    sel = jnp.asarray([[1.0, 0.0]])
    _, _, prob_sel = m.apply(params, f16, f8, f4, jnp.asarray(readout), jnp.asarray(h16),
                             False, True, sel, method=m.segment)

    def nchw(a):
        return torch.from_numpy(np.moveaxis(np.asarray(a), -1, -3).copy())

    t16, t8, t4 = nchw(f16), nchw(f8), nchw(f4)
    with torch.no_grad():
        tv, th = model.encode_value(nchw(frame), t16, nchw(h16), torch.from_numpy(masks))
        thid, tlogits, tprob = model.segment(t16, t8, t4, nchw(readout), nchw(h16), True, False)
        _, _, tprob_sel = model.segment(t16, t8, t4, nchw(readout), nchw(h16), False, True,
                                        torch.tensor([[1.0, 0.0]]))
    close(nhwc(tv), v)
    close(nhwc(th), h)
    close(nhwc(thid), hid)
    close(tlogits, logits)
    close(tprob, prob)
    close(tprob_sel, prob_sel)

    # the training-style readout, top-k and full
    qk = rng.standard_normal((1, 12, 64), np.float32)
    qe = rng.random((1, 12, 64)).astype(np.float32)
    mk = rng.standard_normal((1, 40, 64), np.float32)
    ms = rng.random((1, 40)).astype(np.float32) + 1
    mv = rng.standard_normal((1, 2, 40, 16), np.float32)
    for top_k in (None, 7):
        want = m.apply(params, *map(jnp.asarray, (qk, qe, mk, ms, mv)), top_k,
                       method=m.read_memory)
        got = model.read_memory(*map(torch.from_numpy, (qk, qe, mk, ms, mv)), top_k)
        close(got, want)


def test_memory_attention_math_matches_jax():
    rng = np.random.default_rng(2)
    mk = rng.standard_normal((2, 40, 16), np.float32)
    ms = rng.random((2, 40)).astype(np.float32) + 1.0
    qk = rng.standard_normal((2, 12, 16), np.float32)
    qe = rng.random((2, 12, 16)).astype(np.float32)
    for args in ((mk, ms, qk, qe), (mk, None, qk, None)):
        want = jxm.key_similarity(*(None if a is None else jnp.asarray(a) for a in args))
        got = xm.key_similarity(*(None if a is None else torch.from_numpy(a) for a in args))
        close(got, want, MATH_TOL)
        for top_k in (None, 5):
            wa, wu = jxm.topk_softmax(want, top_k, return_usage=True)
            ga, gu = xm.topk_softmax(got, top_k, return_usage=True)
            close(ga, wa, MATH_TOL)
            close(gu, wu, MATH_TOL)
    prob = rng.random((2, 3, 8, 8)).astype(np.float32)
    for dim in (0, 1):
        wl, wp = jxm.aggregate(jnp.asarray(prob), dim, return_logits=True)
        gl, gp = xm.aggregate(torch.from_numpy(prob), dim, return_logits=True)
        close(gl, wl, MATH_TOL)
        close(gp, wp, MATH_TOL)


def test_pad_unpad_mask_mapper_match_jax():
    for arr in (np.arange(50 * 30 * 3, dtype=np.float32).reshape(50, 30, 3),
                np.ones((2, 50, 30), np.float32), np.ones((3, 64, 48), np.float32)):
        got, pad = trk.pad_divide_by(arr, 16)
        want, jpad = jtrk.pad_divide_by(arr, 16)
        assert pad == jpad and np.array_equal(got, want)
        axes = (0, 1) if arr.shape[-1] == 3 else (1, 2)
        assert np.array_equal(trk.unpad(got, pad, *axes), arr)
    mask = np.zeros((8, 8), np.uint8)
    mask[:2], mask[4:] = 3, 7
    a, b = trk.MaskMapper(), jtrk.MaskMapper()
    (oa, ma), (ob, mb) = a.convert_mask(mask), b.convert_mask(mask)
    assert ma == mb and np.array_equal(oa, ob) and a.remappings == b.remappings
    idx = np.zeros((8, 8), np.uint8)
    idx[:2], idx[4:] = 1, 2
    assert np.array_equal(a.remap_index_mask(idx), b.remap_index_mask(idx))


# ---------------------------------------------------- the memory, both ways


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def same_store(got: trk.KeyValueMemoryStore, want: jtrk.KeyValueMemoryStore):
    assert got.size == want.size and got.num_groups == want.num_groups
    for a, b in ((got.k, want.k), (got.s, want.s), (got.e, want.e)):
        assert (a is None) == (b is None)
        if a is not None:
            close(a, b, MATH_TOL)
    for gi in range(want.num_groups):
        assert (got.v[gi] is None) == (want.v[gi] is None)
        if want.v[gi] is not None:
            close(got.v[gi], want.v[gi], MATH_TOL)
        if gi < len(want.v_idx) and want.v_idx[gi] is not None:
            assert np.array_equal(got.v_idx[gi].numpy(), want.v_idx[gi]), gi
    if want.count_usage:
        close(got.get_usage(), want.get_usage(), MATH_TOL)


def test_store_groups_sieve_and_working_eviction_match_jax():
    """tests/test_xmem.py's working-store scenarios: groups, a late object,
    sieving, eviction with two groups (ties at the threshold all go)."""
    rng = np.random.default_rng(11)
    ck, cv, hw = 4, 6, 10
    a, b = trk.KeyValueMemoryStore(True), jtrk.KeyValueMemoryStore(True)

    def add(objects):
        k = rng.standard_normal((1, hw, ck), np.float32)
        v = rng.standard_normal((len(objects), hw, cv), np.float32)
        s = rng.random((1, hw)).astype(np.float32) + 1
        a.add(t(k), t(v), t(s), None, objects)
        b.add(k, v, s, None, objects)

    add([1])
    add([1, 2])
    same_store(a, b)
    assert a.get_v_size(0) == 2 * hw and a.get_v_size(1) == hw
    usage = np.concatenate([np.zeros(hw), np.ones(hw)]).astype(np.float32)
    a.update_usage(t(usage))
    b.update_usage(usage)
    a.remove_obsolete_features(max_size=hw)
    b.remove_obsolete_features(max_size=hw)
    same_store(a, b)
    usage = np.array([0, 0, 0, 1, 2, 3, 3, 3, 4, 5], np.float32)  # ties at the threshold
    a.update_usage(t(usage))
    b.update_usage(usage)
    a.remove_obsolete_features(max_size=4)
    b.remove_obsolete_features(max_size=4)
    same_store(a, b)
    assert a.size == b.size == 2  # every slot tied at the 6th-smallest usage went
    add([1, 2])
    add([1, 2])
    a.sieve_by_range(2, -hw, min_size=2)
    b.sieve_by_range(2, -hw, min_size=2)
    same_store(a, b)


def test_store_long_term_eviction_exact_alignment_matches_jax():
    rng = np.random.default_rng(5)
    ck, cv = 4, 3
    k1 = rng.standard_normal((1, 5, ck), np.float32)
    v1 = rng.standard_normal((1, 5, cv), np.float32)
    s1 = rng.random((1, 5)).astype(np.float32) + 1
    k2 = rng.standard_normal((1, 4, ck), np.float32)
    v2_0 = rng.standard_normal((1, 4, cv), np.float32)
    v2_1 = rng.standard_normal((1, 2, cv), np.float32)
    s2 = rng.random((1, 4)).astype(np.float32) + 1
    a, b = trk.KeyValueMemoryStore(True), jtrk.KeyValueMemoryStore(True)
    a.add(t(k1), [t(v1), None], t(s1), None, objects=None)
    b.add(k1, [v1, None], s1, None, objects=None)
    a.add(t(k2), [t(v2_0), t(v2_1)], t(s2), None, objects=None,
          value_key_idx=[None, torch.tensor([0, 2])])
    b.add(k2, [v2_0, v2_1], s2, None, objects=None, value_key_idx=[None, np.array([0, 2])])
    same_store(a, b)
    usage = np.array([0, 9, 9, 9, 9, 1, 9, 9, 9], np.float32)
    a.update_usage(t(usage))
    b.update_usage(usage)
    a.remove_obsolete_features(max_size=7)
    b.remove_obsolete_features(max_size=7)
    same_store(a, b)
    assert a.v_idx[1].tolist() == [5] and torch.equal(a.k[0, 5], torch.from_numpy(k2[0, 2]))


def feed_managers(cfg, rounds, n_obj_at, seed, h=4, w=4, ck=4, cv=6, selection=False):
    """Both managers fed the same memory and queries; each round's readout
    compared, the stores compared at the end."""
    rng = np.random.default_rng(seed)
    a, b = trk.MemoryManager(cfg), jtrk.MemoryManager(cfg)

    def add(objects):
        k = rng.standard_normal((1, h, w, ck)).astype(np.float32)
        s = rng.random((1, h, w, 1)).astype(np.float32) + 1.0
        v = rng.standard_normal((1, len(objects), h, w, cv)).astype(np.float32)
        e = rng.random((1, h, w, ck)).astype(np.float32) if selection else None
        a.add_memory(torch.from_numpy(np.moveaxis(k, -1, 1)), torch.from_numpy(
            np.moveaxis(s, -1, 1)), torch.from_numpy(np.moveaxis(v, -1, 2)), objects,
            None if e is None else torch.from_numpy(np.moveaxis(e, -1, 1)))
        b.add_memory(k, s, v, objects, e)

    add([1])
    for i in range(rounds):
        qk = rng.standard_normal((1, h, w, ck)).astype(np.float32)
        qe = rng.random((1, h, w, ck)).astype(np.float32) if selection else None
        got = a.match_memory(torch.from_numpy(np.moveaxis(qk, -1, 1)),
                             None if qe is None else torch.from_numpy(np.moveaxis(qe, -1, 1)))
        want = b.match_memory(qk, qe)
        close(np.moveaxis(got.numpy(), 2, -1), want, MATH_TOL)
        add(list(range(1, n_obj_at(i) + 1)))
    same_store(a.work_mem, b.work_mem)
    if cfg["enable_long_term"]:
        same_store(a.long_mem, b.long_mem)
    return a


def test_manager_working_memory_readout_matches_jax():
    cfg = dict(jtrk.DEFAULT_CONFIG, enable_long_term=False, top_k=5)
    feed_managers(cfg, 3, lambda i: 1, seed=5)


def test_manager_multi_group_long_term_matches_jax():
    """Consolidation with a late second object (None skips, non-suffix
    validity), long-term eviction, selection-weighted keys: the readout of
    every round and the stores at the end."""
    cfg = dict(jtrk.DEFAULT_CONFIG, max_mid_term_frames=3, min_mid_term_frames=2,
               num_prototypes=4, max_long_term_elements=32, top_k=5, hidden_dim=8)
    mm = feed_managers(cfg, 12, lambda i: 1 if i == 0 else 2, seed=3, selection=True)
    assert mm.long_mem.engaged() and mm.long_mem.num_groups == 2
    assert mm.long_mem.v[1] is not None


# ----------------------------------------------------------- inference core


def test_inference_core_over_a_consolidating_clip_matches_jax(nets):
    """8 frames, memory every frame, 3 mid-term frames at most: the working
    memory overflows and consolidates into long-term memory.  Probabilities
    of the first 3 frames within 1e-4, then every frame's mask by IoU."""
    _, params, model = nets
    hw16 = (H // 16) * (W // 16)
    cfg = dict(trk.DEFAULT_CONFIG, mem_every=1, max_mid_term_frames=3, min_mid_term_frames=2,
               num_prototypes=4, max_long_term_elements=hw16 * 5, top_k=5)
    a, b = trk.XMemInferenceCore(model, cfg), jtrk.XMemInferenceCore(jxm.XMem(), params, cfg)
    a.set_all_labels([1, 2])
    b.set_all_labels([1, 2])
    rng = np.random.default_rng(6)
    ious = []
    for ti in range(8):
        img = rng.random((H, W, 3)).astype(np.float32)
        mask = None
        if ti == 0:
            mask = np.zeros((2, H, W), np.float32)
            mask[0, 10:30, 10:25] = 1.0
            mask[1, 40:60, 20:44] = 1.0
        got, want = a.step(img, mask=mask), b.step(img, mask=mask)
        if ti < 3:
            close(got, want)
        lg, lw = got.argmax(0).numpy(), np.asarray(want).argmax(0)
        ious += [np.logical_and(lg == i, lw == i).sum() / max(np.logical_or(
            lg == i, lw == i).sum(), 1) for i in (1, 2)]
    assert a.memory.long_mem.engaged() and b.memory.long_mem.engaged()
    assert a.memory.work_mem.size == b.memory.work_mem.size <= 3 * hw16
    assert min(ious) >= 0.99, ious
