"""Bridge dataset pipeline: flat instance folders -> training batches (the
port's copy of ``this_and_that_vdm_tpu/data/bridge.py``, the reference's
data_loader/video_dataset.py and video_this_that_dataset.py).

* validity scan: sequential ``im_*.jpg``, frame count in
  ``[F, acceleration_tolerance * F]``, ``lang.txt`` when text is on,
  ``data.txt`` for the this/that variant, ``flow.txt`` for the flow-derived
  motion bucket; rejects counted by kind;
* frame subsample: gaps ``[N // F] * (F - 1)`` with the remainder spread
  alternately front / back;
* frames read by the native loader (``data.native_loader``: PNG or JPEG
  by the file's signature through the port's own codecs, bicubic resize on
  uint8 bit-equal to ``data.image.resize_bicubic``, on C++ threads), flip
  aug p = 0.45 suppressed when the prompt mentions left / right; a frame
  that cannot be decoded raises;
* ``mix_ambiguous``: prompt rewrite to this / there with the 0.4/0.2/0.2/0.2
  mixture from ``processed_text.txt``;
* motion bucket: fixed ``motion_bucket_id``, or per-video flow -> z-score ->
  SVD bucket when it is None.

Augmentations are drawn from a per-item ``random.Random(hash((seed, epoch,
idx)))``, as in the JAX package, so flips and prompt mixing equal its draws.
Pure numpy on the host; ``PrefetchLoader`` feeds the train step.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import random
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..utils.video_io import read_image
from . import native_loader
from .image import resize_bicubic
from .rasterize import load_condition


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_path: Sequence[str] = ()
    video_seq_length: int = 14
    height: int = 256
    width: int = 384
    flip_aug_prob: float = 0.45
    acceleration_tolerance: int = 4
    use_text: bool = True
    mix_ambiguous: bool = False
    empty_prompts_proportion: float = 0.0
    motion_bucket_id: Optional[int] = 200
    dataset_motion_mean: float = 35.3
    dataset_motion_std: float = 18.5
    svd_motion_mean: float = 165.0
    svd_motion_std: float = 22.5
    conditioning_channels: int = 3
    dilate: bool = True


def subsample_indices(num_input: int, num_needed: int) -> List[int]:
    """The reference's gap algorithm (video_dataset.py:24-55)."""
    division = num_input // num_needed
    remain = (num_input % num_needed) - 1
    gaps = [division] * (num_needed - 1)
    for idx in range(remain):
        if idx % 2 == 0:
            gaps[idx // 2] += 1
        else:
            gaps[-1 * (1 + idx // 2)] += 1
    out = [0]
    for g in gaps:
        out.append(out[-1] + g)
    return out


def _count_frames(path: str) -> int:
    return sum(1 for f in os.listdir(path) if f.startswith("im_"))


def load_frames(path: str, indices: Sequence[int], hw, flip: bool = False,
                normalized: bool = False) -> np.ndarray:
    """``[len(indices), H, W, 3]`` float32 RGB of ``im_<i>.jpg``: decoded,
    resized bicubic on uint8 (as cv2 resizes a uint8 image), optionally
    flipped; in [0, 255], or [-1, 1] when ``normalized``.  Through the
    native loader (as the JAX package once its library is built)."""
    paths = [os.path.join(path, f"im_{i}.jpg") for i in indices]
    if normalized:
        return native_loader.load_frames_native(paths, hw, flip)
    return native_loader.load_frames_native_u8(paths, hw, flip).astype(np.float32)


def load_frames_plain(path: str, indices: Sequence[int], hw, flip: bool = False,
                      normalized: bool = False) -> np.ndarray:
    """``load_frames`` one frame at a time in Python (``read_image``, then
    numpy's ``resize_bicubic``): the plain version the native loader is
    held to."""
    h, w = hw
    frames = []
    for i in indices:
        img = resize_bicubic(read_image(os.path.join(path, f"im_{i}.jpg")), h, w)
        frames.append(np.fliplr(img) if flip else img)
    out = np.stack(frames).astype(np.float32)
    return out / 127.5 - 1.0 if normalized else out


def scan_valid_instances(cfg: DataConfig, require_gesture: bool = False) -> List[str]:
    """The instance folders under ``cfg.dataset_path`` that pass every check,
    in sorted order; prints the count of each kind of reject."""
    valid = []
    stats = {}
    for root in cfg.dataset_path:
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if not os.path.isdir(path):
                continue
            files = set(os.listdir(path))
            n = sum(1 for f in files if f.startswith("im_"))
            if any(f"im_{i}.jpg" not in files for i in range(n)):
                reject = "incomplete_img"
            elif n < cfg.video_seq_length:
                reject = "too_little_frames"
            elif not require_gesture and n > cfg.acceleration_tolerance * cfg.video_seq_length:
                reject = "too_many_frames"
            elif cfg.use_text and "lang.txt" not in files:
                reject = "no_lang_txt"
            elif require_gesture and "data.txt" not in files:
                reject = "no_data_txt"
            elif cfg.motion_bucket_id is None and "flow.txt" not in files:
                # the flow-derived motion bucket needs the per-video flow
                reject = "no_flow_txt"
            else:
                valid.append(path)
                continue
            stats[reject] = stats.get(reject, 0) + 1
    if stats:
        print("dataset scan rejects:", stats)
    return valid


def _motion_bucket(cfg: DataConfig, path: str) -> int:
    if cfg.motion_bucket_id is not None:
        return int(cfg.motion_bucket_id)
    with open(os.path.join(path, "flow.txt")) as f:
        per_video = float(f.readlines()[0][:-2])
    corrected = per_video * (_count_frames(path) / cfg.video_seq_length)
    z = (corrected - cfg.dataset_motion_mean) / (cfg.dataset_motion_std + 0.001)
    return int(z * cfg.svd_motion_std + cfg.svd_motion_mean)


def ambiguous_prompt(prompt: str) -> str:
    """Inference-time full rewrite: "<verb> this to there" (reference
    test_code/inference.py:100-102)."""
    words = prompt.split()  # split() (not split(" ")) so "" -> [] -> default
    return (words[0] if words else "move") + " this to there"


def _read_prompt(cfg: DataConfig, path: str, rng: random.Random) -> str:
    if not cfg.use_text:
        return ""
    with open(os.path.join(path, "lang.txt")) as f:
        prompt = f.readlines()[0]
    proc = os.path.join(path, "processed_text.txt")
    if cfg.mix_ambiguous and os.path.exists(proc):
        with open(proc) as f:
            lines = f.readlines()
        action, this, there = lines[0][:-1], lines[1][:-1], lines[2][:-1]
        r = rng.random()
        if 0.4 <= r < 0.6:
            prompt = f"{action} this to {there}"
        elif 0.6 <= r < 0.8:
            prompt = f"{action} {this} to there"
        elif r >= 0.8:
            prompt = f"{action} this to there"
    return prompt


class VideoDataset:
    """VL training dataset: frames + tokenized prompt + motion bucket.

    Augmentation draws are a pure function of (seed, epoch, index): loader
    workers call ``__getitem__`` concurrently, and one shared stream would
    make flips and prompt mixing depend on thread scheduling.  ``set_epoch``
    (called by ``PrefetchLoader`` each epoch) re-rolls them."""

    require_gesture = False

    def __init__(self, cfg: DataConfig, tokenize: Callable[[str], np.ndarray],
                 seed: int = 42):
        self.cfg = cfg
        self.tokenize = tokenize
        self.paths = scan_valid_instances(cfg, require_gesture=self.require_gesture)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _item_rng(self, idx: int) -> random.Random:
        # the hash of an int tuple is the same in every process
        # (PYTHONHASHSEED salts only str / bytes hashing)
        return random.Random(hash((self.seed, self.epoch, idx)))

    def __len__(self):
        return len(self.paths)

    def _flip(self, prompt: str, rng: random.Random) -> bool:
        if rng.random() >= self.cfg.flip_aug_prob:
            return False
        if self.cfg.use_text and ("left" in prompt or "right" in prompt):
            return False
        return True

    def _prompt_and_flip(self, idx: int):
        rng = self._item_rng(idx)
        path = self.paths[idx]
        prompt = _read_prompt(self.cfg, path, rng)
        # flip suppression reads the real caption: blank it after deciding
        flip = self._flip(prompt, rng)
        if rng.random() < self.cfg.empty_prompts_proportion:
            prompt = ""
        return path, prompt, flip

    def __getitem__(self, idx: int) -> dict:
        path, prompt, flip = self._prompt_and_flip(idx)
        indices = subsample_indices(_count_frames(path), self.cfg.video_seq_length)
        frames = load_frames(path, indices, (self.cfg.height, self.cfg.width), flip,
                             normalized=True)
        return dict(
            video_frames=frames,  # [F, H, W, 3] in [-1, 1]
            prompt_ids=self.tokenize(prompt),
            motion_bucket_id=np.float32(_motion_bucket(self.cfg, path)),
        )


class VideoThisThatDataset(VideoDataset):
    """VGL dataset: adds the rasterised gesture condition; frames are the
    first F (curation already resampled them)."""

    require_gesture = True

    def __getitem__(self, idx: int) -> dict:
        path, prompt, flip = self._prompt_and_flip(idx)
        hw = (self.cfg.height, self.cfg.width)
        frames = load_frames(path, range(self.cfg.video_seq_length), hw, flip,
                             normalized=True)
        cond, motion, ctrl_idx, _ = load_condition(path, hw, self.cfg.video_seq_length,
                                                   flip=flip, dilate=self.cfg.dilate)
        return dict(
            video_frames=frames,
            prompt_ids=self.tokenize(prompt),
            motion_bucket_id=np.float32(
                motion if self.cfg.motion_bucket_id is None else self.cfg.motion_bucket_id),
            condition=cond,  # [F, H, W, 3] in [0, 1]
            controlnet_image_index=np.asarray(ctrl_idx, np.int32),
        )


class _WorkerError:
    """An exception raised inside a loader worker, for the consumer to
    re-raise (a worker cannot raise across threads)."""

    def __init__(self, exc: Exception):
        self.exc = exc


class PrefetchLoader:
    """Threaded shuffling batch loader on the host.

    Each epoch (one ``__iter__``) takes the permutation of
    ``RandomState(seed + epoch)``, calls ``dataset.set_epoch``, and yields
    the full batches in that order whatever the workers' timing (a reorder
    buffer).  A worker may start a batch only while fewer than
    ``2 * num_workers`` are un-yielded.  A worker's error is re-raised in the
    consumer; leaving the loop early releases the workers.  ``shard=(rank,
    world)`` gives each rank a disjoint stride of the same batch list,
    truncated so that every rank yields the same count.  Collates numpy
    dicts; ``controlnet_image_index`` (ragged) is dropped."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, seed: int = 42,
                 drop_keys=("controlnet_image_index",), shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.drop_keys = drop_keys
        self.shard = tuple(shard)
        if not 0 <= self.shard[0] < self.shard[1]:
            raise ValueError(f"shard {shard} is not (rank, world) with 0 <= rank < world")
        self._epoch = 0

    def __iter__(self):
        epoch, self._epoch = self._epoch, self._epoch + 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = np.random.RandomState(self.seed + epoch).permutation(len(self.dataset))
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2 * self.num_workers)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order) - self.batch_size + 1, self.batch_size)]
        rank, world = self.shard
        if world > 1:
            batches = batches[:len(batches) - len(batches) % world][rank::world]
            if not batches:
                # a training loop over epochs would spin forever on empty ones
                raise ValueError(
                    f"dataset yields {len(order) // self.batch_size} full batches, fewer "
                    f"than world={world}: every rank would get zero batches (grow the "
                    "dataset or shrink the batch)")
        it = iter(enumerate(batches))
        lock = threading.Lock()
        sentinel = object()
        # a ticket is released when the consumer yields a batch, not when it
        # dequeues one: otherwise one slow batch lets the others pile up in
        # ``pending`` without limit
        tickets = threading.Semaphore(2 * self.num_workers)
        stop = threading.Event()

        def worker():
            while True:
                tickets.acquire()
                if stop.is_set():
                    return
                with lock:
                    job = next(it, None)
                if job is None:
                    tickets.release()
                    q.put((None, sentinel))
                    return
                bidx, idxs = job
                try:
                    items = [self.dataset[int(i)] for i in idxs]
                    batch = {k: np.stack([x[k] for x in items]) for k in items[0]
                             if k not in self.drop_keys}
                except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
                    q.put((bidx, _WorkerError(e)))
                    return
                q.put((bidx, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        pending: dict = {}
        next_idx = done = 0
        try:
            while done < self.num_workers or pending:
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    tickets.release()
                    next_idx += 1
                if done == self.num_workers and not pending:
                    break
                bidx, item = q.get()
                if item is sentinel:
                    done += 1
                    continue
                if isinstance(item, _WorkerError):
                    raise RuntimeError(f"PrefetchLoader worker failed on batch {bidx} "
                                       "(dataset item error)") from item.exc
                pending[bidx] = item
            while next_idx in pending:
                yield pending.pop(next_idx)
                tickets.release()
                next_idx += 1
        finally:
            # early break, error or garbage collection of the generator:
            # wake the workers blocked on q.put / tickets.acquire so they see
            # ``stop`` and exit
            stop.set()
            deadline = time.monotonic() + 10.0
            while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    pass
                tickets.release()
                for t in threads:
                    t.join(timeout=0.005)
