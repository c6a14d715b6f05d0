"""Curation and dataset utilities (counterpart of ``curation/tools.py``;
reference scripts/ and curation_pipeline/).

* ``match_instance``: find a flat instance back in a raw tree by exact
  image equality, confirmed over several frames (match_dataset_v{1,2}.py).
* ``visualize_points``: gesture points drawn on a frame.
* ``collect_lang`` / ``ingest_llama_decomposition``: gather prompts and
  write ``processed_text.txt`` (scripts/collect_lang.py, process_llama.py).
* ``length_stats`` / ``clean_dataset`` / ``check_videos``: dataset hygiene.
* ``resize_video_seq`` / ``truncate_video_frames`` / ``extract_test_paths``
  / ``generate_noise_images`` / ``active_learning_select`` /
  ``process_sim_dataset``: the remaining dataset scripts.

Images are read by content (``utils/video_io.read_image``) and written as
PNG bytes, so none of this needs cv2 except ``check_videos``, which decodes
videos with it and says so where it is missing.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.image import resize_bicubic
from ..utils.video_io import read_image, write_png
from .painters import filled_circle


def _same_image(a: str, b: str) -> bool:
    x, y = read_image(a), read_image(b)
    return x.shape == y.shape and np.array_equal(x, y)


def match_instance(instance_dir: str, candidate_dirs: Sequence[str],
                   confirm_frames: int = 10) -> Optional[str]:
    """The raw trajectory whose frames equal a flat instance's."""
    probe = os.path.join(instance_dir, "im_0.jpg")
    for cand in candidate_dirs:
        c0 = os.path.join(cand, "im_0.jpg")
        if not os.path.exists(c0) or not _same_image(probe, c0):
            continue
        ok = True
        for i in range(1, confirm_frames):
            a = os.path.join(instance_dir, f"im_{i}.jpg")
            b = os.path.join(cand, f"im_{i}.jpg")
            if not (os.path.exists(a) and os.path.exists(b)):
                break
            if not _same_image(a, b):
                ok = False
                break
        if ok:
            return cand
    return None


def visualize_points(image_rgb: np.ndarray, points_xy: Sequence[Tuple[float, float]],
                     radius: int = 8) -> np.ndarray:
    """The first point red, the others green, as filled discs."""
    colors = [(255, 0, 0), (0, 255, 0)]
    out = image_rgb.copy()
    for i, (x, y) in enumerate(points_xy):
        filled_circle(out, (int(x), int(y)), radius, colors[min(i, 1)])
    return out


def collect_lang(instance_root: str) -> Dict[str, str]:
    out = {}
    for name in sorted(os.listdir(instance_root)):
        p = os.path.join(instance_root, name, "lang.txt")
        if os.path.exists(p):
            with open(p) as f:
                out[name] = f.readlines()[0].strip()
    return out


def ingest_llama_decomposition(instance_dir: str, action: str, this: str, there: str) -> str:
    """Write ``processed_text.txt`` (the mix_ambiguous source)."""
    path = os.path.join(instance_dir, "processed_text.txt")
    with open(path, "w") as f:
        f.write(f"{action}\n{this}\n{there}\n")
    return path


def length_stats(instance_root: str) -> Dict[str, float]:
    lengths = [sum(1 for f in os.listdir(os.path.join(instance_root, name))
                   if f.startswith("im_"))
               for name in sorted(os.listdir(instance_root))
               if os.path.isdir(os.path.join(instance_root, name))]
    arr = np.asarray(lengths, np.float64)
    return {"count": len(arr), "mean": float(arr.mean()) if len(arr) else 0.0,
            "min": float(arr.min()) if len(arr) else 0.0,
            "max": float(arr.max()) if len(arr) else 0.0}


def clean_dataset(instance_root: str, min_frames: int = 14,
                  require: Sequence[str] = ("lang.txt",)) -> List[str]:
    """Remove invalid instances; returns the removed paths."""
    removed = []
    for name in sorted(os.listdir(instance_root)):
        d = os.path.join(instance_root, name)
        if not os.path.isdir(d):
            continue
        files = set(os.listdir(d))
        n = sum(1 for f in files if f.startswith("im_"))
        if (n < min_frames or any(r not in files for r in require)
                or any(f"im_{i}.jpg" not in files for i in range(n))):
            shutil.rmtree(d)
            removed.append(d)
    return removed


def resize_video_seq(input_dir: str, store_dir: str,
                     target_hw: Tuple[int, int] = (256, 384)) -> int:
    """Resize every frame of every video folder with cv2's bicubic
    (``data/image.resize_bicubic``; reference scripts/resize_video_seq.py),
    written as PNG bytes under the same names.  Returns the count."""
    os.makedirs(store_dir, exist_ok=True)
    n = 0
    for video in sorted(os.listdir(input_dir)):
        src = os.path.join(input_dir, video)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(store_dir, video)
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            if name.endswith((".jpg", ".png")):
                img = resize_bicubic(read_image(os.path.join(src, name)), *target_hw)
                write_png(os.path.join(dst, name), img)
                n += 1
    return n


def truncate_video_frames(folder: str, needed_frames: int = 14, ext: str = ".png") -> int:
    """Delete frames with index >= needed_frames in every video folder
    (reference scripts/crop_video_frames.py).  Returns the count removed."""
    removed = 0
    for video in sorted(os.listdir(folder)):
        sub = os.path.join(folder, video)
        if not os.path.isdir(sub):
            continue
        for idx in range(needed_frames, len(os.listdir(sub))):
            p = os.path.join(sub, f"{idx}{ext}")
            if os.path.exists(p):
                os.remove(p)
                removed += 1
    return removed


def extract_test_paths(match_info_txt: str, store_txt: str, strip_prefix: str = "") -> int:
    """Second column of a match-info file -> relative test-instance paths
    (reference scripts/extract_test_dataset.py)."""
    n = 0
    with open(match_info_txt) as rf, open(store_txt, "w") as wf:
        for line in rf:
            parts = line.split(" ")
            if len(parts) < 2:
                continue
            p = parts[1]
            if strip_prefix and p.startswith(strip_prefix):
                p = p[len(strip_prefix):]
            wf.write(p if p.endswith("\n") else p + "\n")
            n += 1
    return n


def generate_noise_images(store_dir: str, count: int = 4, hw: Tuple[int, int] = (256, 256),
                          seed: int = 0) -> List[str]:
    """Uniform-noise control images (reference scripts/generate_noise.py)."""
    os.makedirs(store_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for idx in range(count):
        noise = (rng.random((hw[0], hw[1], 3)) * 255).astype(np.uint8)
        paths.append(write_png(os.path.join(store_dir, f"noise{idx}.png"), noise))
    return paths


def check_videos(video_dir: str, delete_abnormal: bool = False) -> List[str]:
    """Unreadable video files, optionally deleted (reference
    scripts/check_video.py).  Decoding a video needs cv2."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("check_videos decodes videos with cv2, which is not "
                           "installed") from None
    bad = []
    for name in sorted(os.listdir(video_dir)):
        path = os.path.join(video_dir, name)
        cap = cv2.VideoCapture(path)
        ok, _ = cap.read()
        cap.release()
        if not ok:
            bad.append(path)
            if delete_abnormal:
                os.remove(path)
    return bad


def active_learning_select(failure_dir: str, dest_dir: str, max_samples: int = 100) -> int:
    """Copy curation-failure frames for relabeling."""
    os.makedirs(dest_dir, exist_ok=True)
    names = sorted(os.listdir(failure_dir))[:max_samples]
    for n in names:
        shutil.copyfile(os.path.join(failure_dir, n), os.path.join(dest_dir, n))
    return len(names)


def process_sim_dataset(sim_root: str, store_root: str, prompts_per_scene: int = 10,
                        most_descriptive_prompt_idx: int = 6) -> int:
    """Flatten an IsaacGym pick-place export into training instances
    (reference scripts/process_sim.py:22-58): scene ``idx`` copies the
    files of ``run_<prompts_per_scene * idx>`` and writes a ``lang.txt``
    with the most descriptive prompt first, then the others in run order.
    As in the JAX tool, the scene count is ``len(listdir) //
    prompts_per_scene``, prompts compact over missing ``lang.txt`` files,
    and a scene with too few prompts is skipped.  Returns the scenes
    exported."""
    os.makedirs(store_root, exist_ok=True)
    exported = 0
    for idx in range(len(os.listdir(sim_root)) // prompts_per_scene):
        base = os.path.join(sim_root, f"run_{prompts_per_scene * idx}")
        if not os.path.isdir(base):
            continue
        prompts = []
        for j in range(prompts_per_scene):
            lang = os.path.join(sim_root, f"run_{prompts_per_scene * idx + j}", "lang.txt")
            if os.path.exists(lang):
                with open(lang) as f:
                    prompts.append(f.readline().rstrip("\n"))
        if len(prompts) <= most_descriptive_prompt_idx:
            continue
        dest = os.path.join(store_root, str(idx))
        os.makedirs(dest, exist_ok=True)
        for name in os.listdir(base):
            if name != "lang.txt":
                shutil.copyfile(os.path.join(base, name), os.path.join(dest, name))
        ordered = [prompts[most_descriptive_prompt_idx]] + [
            p for j, p in enumerate(prompts) if j != most_descriptive_prompt_idx]
        with open(os.path.join(dest, "lang.txt"), "w") as f:
            f.write("\n".join(ordered) + "\n")
        exported += 1
    return exported
