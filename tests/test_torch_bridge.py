"""The port's Bridge loader (data/bridge.py) against the JAX package's on
the same instance trees (CPU).

- ``subsample_indices``: equal over a grid of (N, F).
- ``scan_valid_instances``: the same list and the same printed rejects, on
  a tree with every kind of reject.
- ``VideoDataset`` / ``VideoThisThatDataset``, item by item for the same seed
  over two epochs: prompt ids (the same tokenize callable), flip decision,
  motion bucket (fixed and from ``flow.txt``) and ``mix_ambiguous`` prompts
  exactly equal; the gesture condition within 1e-5 (the rasteriser's bound);
  frames within one uint8 level (1 / 127.5) with at least 99.9% of the
  levels equal, against the JAX package's cv2 frame path (the port's float64
  bicubic equals it at every level measured); against its native C++
  loader, which itself differs from its cv2 path at ~0.2% of levels, within
  one level with at least 99.5% equal.
- ``PrefetchLoader``: the same batch order as the JAX loader over two
  epochs with 3 workers; a worker's error re-raised; an early break
  releases the workers; ranks that starve raise.
"""

import os
import random
import threading
import time

import cv2
import numpy as np
import pytest

from this_and_that_vdm_tpu.data import bridge as jbridge
from this_and_that_vdm_tpu.data import native_loader as jnative_loader

from this_and_that_vdm_tpu_torch.cli.tokenizer import hash_tokenizer
from this_and_that_vdm_tpu_torch.data import bridge
from this_and_that_vdm_tpu_torch.utils import video_io

FR, H, W = 4, 32, 48
ORIG = (60, 80)
LEVEL = 1.0 / 127.5
PROMPTS = ("pick up the red block", "push the cup to the left", "open the drawer",
           "move the spoon right", "put the pot in the sink")


def _tokenize():
    tok = hash_tokenizer()
    return lambda s: tok(s)[0]


def _image(rng):
    """A smooth RGB uint8 image at ORIG (seeded noise, blurred)."""
    return cv2.GaussianBlur((rng.rand(*ORIG, 3) * 255).astype(np.uint8), (7, 7), 2)


def _write_instance(d, n, rng, prompt="pick up the block", gesture=None, flow=None,
                    processed=None, png=False, skip_frame=None, lang=True):
    os.makedirs(d)
    for i in range(n):
        if i == skip_frame:
            continue
        path = os.path.join(d, f"im_{i}.jpg")
        if png:  # PNG bytes under the .jpg name: read by content in both packages
            video_io.write_png(path, _image(rng))
        else:
            cv2.imwrite(path, _image(rng)[:, :, ::-1])
    if lang:
        with open(os.path.join(d, "lang.txt"), "w") as f:
            f.write(prompt + "\n")
    if gesture is not None:
        with open(os.path.join(d, "data.txt"), "w") as f:
            f.write("".join(f"{fr} {x} {y}\n" for fr, x, y in gesture))
    if flow is not None:
        with open(os.path.join(d, "flow.txt"), "w") as f:
            f.write(f"{flow}\n")
    if processed is not None:
        with open(os.path.join(d, "processed_text.txt"), "w") as f:
            f.write("".join(line + "\n" for line in processed))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Valid instances for both datasets (JPEG and PNG-bytes frames, 4-16
    frames, 1- and 2-point gestures, flow.txt, processed_text.txt), plus one
    instance of every reject kind."""
    root = str(tmp_path_factory.mktemp("bridge"))
    rng = np.random.RandomState(0)
    gestures = ([(0, 20.0, 30.0)], [(0, 15.0, 12.0), (FR - 1, 60.0, 45.0)])
    for i, n in enumerate((4, 7, 11, 16, 5, 9)):
        _write_instance(os.path.join(root, f"inst{i}"), n, rng, PROMPTS[i % len(PROMPTS)],
                        gesture=gestures[i % 2], flow=f"{10.0 + 7.3 * i:.2f}",
                        processed=("push", "the cup", "the plate"), png=i in (1, 4))
    _write_instance(os.path.join(root, "r_incomplete"), 6, rng, skip_frame=2, gesture=[])
    _write_instance(os.path.join(root, "r_short"), FR - 1, rng, gesture=[], flow="1.00")
    _write_instance(os.path.join(root, "r_long"), 4 * FR + 1, rng, gesture=[(0, 1.0, 1.0)],
                    flow="1.00")
    _write_instance(os.path.join(root, "r_nolang"), FR, rng, lang=False, gesture=[],
                    flow="1.00")
    _write_instance(os.path.join(root, "r_nodata"), FR, rng, flow="1.00")
    _write_instance(os.path.join(root, "r_noflow"), FR, rng, gesture=[(0, 1.0, 1.0)])
    with open(os.path.join(root, "not_a_folder.txt"), "w") as f:
        f.write("x")
    return root


def _cfgs(root, **kw):
    kw = dict(dataset_path=[root], video_seq_length=FR, height=H, width=W, **kw)
    return bridge.DataConfig(**kw), jbridge.DataConfig(**kw)


@pytest.mark.parametrize("n,f", [(14, 14), (15, 14), (20, 14), (27, 14), (56, 14), (57, 14),
                                 (5, 4), (16, 4), (9, 2), (100, 25)])
def test_subsample_indices_match_jax(n, f):
    assert bridge.subsample_indices(n, f) == jbridge.subsample_indices(n, f)


@pytest.mark.parametrize("gesture,motion", [(False, 200), (True, 200), (False, None),
                                            (True, None)])
def test_scan_valid_instances_matches_jax(tree, capsys, gesture, motion):
    cfg, jcfg = _cfgs(tree, motion_bucket_id=motion)
    got = bridge.scan_valid_instances(cfg, require_gesture=gesture)
    got_out = capsys.readouterr().out
    want = jbridge.scan_valid_instances(jcfg, require_gesture=gesture)
    assert got == want and len(got) >= 5
    assert got_out == capsys.readouterr().out
    assert "incomplete_img" in got_out and "too_little_frames" in got_out
    assert ("no_data_txt" in got_out) == gesture and ("too_many_frames" in got_out) != gesture
    assert ("no_flow_txt" in got_out) == (motion is None)


def _compare_items(ds, jds, frame_stats):
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        assert len(ds) == len(jds) >= 5
        for idx in range(len(ds)):
            # the augmentation draws: prompt (mix_ambiguous) and flip
            rng = jds._item_rng(idx)
            prompt = jbridge._read_prompt(jds.cfg, jds.paths[idx], rng)
            want_flip = jds._flip(prompt, rng)
            path, got_prompt, got_flip = ds._prompt_and_flip(idx)
            assert path == jds.paths[idx]
            if rng.random() < jds.cfg.empty_prompts_proportion:
                prompt = ""
            assert (got_prompt, got_flip) == (prompt, want_flip)
            got, want = ds[idx], jds[idx]
            assert set(got) == set(want)
            np.testing.assert_array_equal(got["prompt_ids"], want["prompt_ids"])
            assert got["motion_bucket_id"] == want["motion_bucket_id"]
            assert got["motion_bucket_id"].dtype == np.float32
            gf, wf = got["video_frames"], want["video_frames"]
            assert gf.shape == wf.shape == (FR, H, W, 3) and gf.dtype == np.float32
            assert np.abs(gf - wf).max() <= LEVEL * 1.0001
            # equal as uint8 levels (the JAX native loader scales in another
            # float order, so equal levels may differ in the last ulp)
            lv = np.abs(np.round((gf + 1) * 127.5) - np.round((wf + 1) * 127.5))
            frame_stats.append((float(np.mean(lv == 0)), float(lv.max())))
            if "condition" in want:
                np.testing.assert_allclose(got["condition"], want["condition"], rtol=0,
                                           atol=1e-5)
                np.testing.assert_array_equal(got["controlnet_image_index"],
                                              want["controlnet_image_index"])


@pytest.mark.parametrize("which", ["vl", "vgl"])
@pytest.mark.parametrize("motion,mix", [(200, False), (None, True)])
def test_dataset_items_match_jax(tree, monkeypatch, which, motion, mix):
    monkeypatch.setattr(jnative_loader, "available", lambda: False)  # the cv2 frame path
    cfg, jcfg = _cfgs(tree, motion_bucket_id=motion, mix_ambiguous=mix, flip_aug_prob=0.5,
                      empty_prompts_proportion=0.2 if mix else 0.0)
    cls, jcls = ((bridge.VideoDataset, jbridge.VideoDataset) if which == "vl" else
                 (bridge.VideoThisThatDataset, jbridge.VideoThisThatDataset))
    tok = _tokenize()
    stats = []
    _compare_items(cls(cfg, tok, seed=7), jcls(jcfg, tok, seed=7), stats)
    equal = min(s[0] for s in stats)
    print(f"{which}: share of equal uint8 levels min {equal:.6f}, largest difference "
          f"{max(s[1] for s in stats):.0f} level(s) over {len(stats)} items")
    assert np.mean([s[0] for s in stats]) >= 0.999


def test_frames_match_jax_native_loader_within_one_level(tree):
    cfg, jcfg = _cfgs(tree, flip_aug_prob=0.5)
    tok = _tokenize()
    ds, jds = bridge.VideoDataset(cfg, tok, seed=3), jbridge.VideoDataset(jcfg, tok, seed=3)
    stats = []
    _compare_items(ds, jds, stats)
    share = float(np.mean([s[0] for s in stats]))
    print(f"native loader: share of equal uint8 levels {share:.6f} over {len(stats)} items")
    assert share >= 0.995


def test_dataset_draws_exercise_flips_and_mixing(tree):
    """The draws above cover both flip outcomes and every prompt rewrite."""
    cfg, _ = _cfgs(tree, mix_ambiguous=True, flip_aug_prob=0.5)
    ds = bridge.VideoDataset(cfg, _tokenize(), seed=7)
    flips, prompts = set(), set()
    for epoch in range(6):
        ds.set_epoch(epoch)
        for idx in range(len(ds)):
            _, prompt, flip = ds._prompt_and_flip(idx)
            flips.add(flip)
            prompts.add(prompt.split(" to ")[-1].strip() if " to " in prompt else prompt)
    assert flips == {False, True}
    assert {"the plate", "there"} <= prompts


def test_motion_bucket_from_flow_matches_jax(tree):
    cfg, jcfg = _cfgs(tree, motion_bucket_id=None)
    for path in bridge.scan_valid_instances(cfg):
        assert bridge._motion_bucket(cfg, path) == jbridge._motion_bucket(jcfg, path)


def test_unreadable_frame_raises(tmp_path):
    d = tmp_path / "i0"
    _write_instance(str(d), FR, np.random.RandomState(1))
    with open(d / "im_2.jpg", "wb") as f:
        f.write(b"not an image")
    cfg, _ = _cfgs(str(tmp_path))
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        bridge.VideoDataset(cfg, _tokenize())[0]


class _Items:
    """A dataset of ``{"idx": i}`` whose items take random time; raises at
    ``fail``."""

    def __init__(self, n, fail=None):
        self.n, self.fail = n, fail
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(random.random() * 0.003)
        if i == self.fail:
            raise KeyError(f"item {i}")
        return {"idx": np.int64(i), "controlnet_image_index": np.zeros(i % 3 + 1)}


def _orders(loader, epochs):
    return [[b["idx"].tolist() for b in loader] for _ in range(epochs)]


@pytest.mark.parametrize("batch", [1, 2])
def test_prefetch_loader_order_matches_jax(batch):
    got_ds, want_ds = _Items(11), _Items(11)
    got = _orders(bridge.PrefetchLoader(got_ds, batch, num_workers=3, seed=5), 2)
    want = _orders(jbridge.PrefetchLoader(want_ds, batch, num_workers=3, seed=5), 2)
    assert got == want and got[0] != got[1]
    assert got_ds.epochs == want_ds.epochs == [0, 1]
    assert all(len(b) == batch for b in got[0]) and len(got[0]) == 11 // batch
    assert sorted(sum(got[0], [])) == sorted(sum(want[0], []))


def test_prefetch_loader_reraises_worker_error():
    loader = bridge.PrefetchLoader(_Items(9, fail=4), 1, num_workers=3, seed=0)
    with pytest.raises(RuntimeError, match="worker failed") as e:
        list(loader)
    assert isinstance(e.value.__cause__, KeyError)


def test_prefetch_loader_early_break_releases_workers():
    before = threading.active_count()
    it = iter(bridge.PrefetchLoader(_Items(64), 1, num_workers=3, seed=0))
    assert next(it)["idx"].shape == (1,)
    it.close()  # what a `break` out of the loop and collection of the generator do
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_prefetch_loader_shards_and_starvation():
    shards = [_orders(bridge.PrefetchLoader(_Items(10), 2, num_workers=2, seed=3,
                                            shard=(r, 2)), 1)[0] for r in range(2)]
    want = [_orders(jbridge.PrefetchLoader(_Items(10), 2, num_workers=2, seed=3,
                                           shard=(r, 2)), 1)[0] for r in range(2)]
    assert shards == want and len(shards[0]) == len(shards[1]) == 2
    with pytest.raises(ValueError, match="fewer than world=4"):
        next(iter(bridge.PrefetchLoader(_Items(3), 1, num_workers=2, shard=(1, 4))))
