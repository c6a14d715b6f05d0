"""Validation in training: render held-out instances through the inference
pipeline every N steps (counterpart of
``this_and_that_vdm_tpu/training/validation.py``; the reference's
``log_validation``, train_code/train_svd.py:85-201 / train_csvd.py:93-219).
The pipeline holds the live training models; each instance's frames go to
``<output_dir>/step_<N>/<instance>/{0..F-1}.png`` and ``combined.gif``.

The models keep their train / eval mode, and the pipelines run under
``torch.no_grad`` and restore autograd when they return, so the next
training step finds everything as it left it.  Mixed dtypes need no cast
here: the UNet casts its inputs and a ControlNet's residuals to its own
dtype.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.image import resize_bicubic
from ..data.rasterize import load_condition
from ..utils import video_io


def render_validation(
    step: int,
    output_dir: str,
    pipeline,
    instances_dir: str,
    tokenize,
    mode: str = "vl",
    num_frames: int = 14,
    height: int = 256,
    width: int = 384,
    num_inference_steps: int = 25,
    motion_bucket_id: int = 200,
    max_instances: Optional[int] = None,
    seed: int = 42,
    write: bool = True,
) -> list:
    """Render every instance folder of ``instances_dir`` (``im_0.jpg``,
    ``lang.txt``, and in VGL ``data.txt``; others are skipped) with
    ``tokenize(prompt) -> [1, 77]`` ids and the draws of
    ``torch.Generator(device).manual_seed(seed)``; returns the folders
    written (``write``; else renders alone, as the ranks beside rank 0 do
    when the towers are split over them, and returns the folders rank 0
    writes)."""
    out_root = os.path.join(output_dir, f"step_{step}")
    written = []
    names = sorted(d for d in os.listdir(instances_dir)
                   if os.path.isdir(os.path.join(instances_dir, d)))[:max_instances or None]
    for name in names:
        inst = os.path.join(instances_dir, name)
        img_path = os.path.join(inst, "im_0.jpg")
        if not os.path.exists(img_path):
            continue
        img = resize_bicubic(video_io.read_image(img_path), height, width)
        img = img.astype(np.float32) / 127.5 - 1.0

        prompt = ""
        lang = os.path.join(inst, "lang.txt")
        if os.path.exists(lang):
            # an empty lang.txt must not stop the training run
            with open(lang) as f:
                prompt = f.readline().strip()
        call = dict(prompt_ids=tokenize(prompt), num_frames=num_frames,
                    num_inference_steps=num_inference_steps,
                    motion_bucket_id=motion_bucket_id, noise_aug_strength=0.1,
                    decode_chunk_size=8,
                    generator=torch.Generator(device=pipeline.device).manual_seed(seed),
                    output_type="uint8")
        if mode == "vgl":
            if not os.path.exists(os.path.join(inst, "data.txt")):
                continue
            cond, _, _, _ = load_condition(inst, (height, width), num_frames)
            frames = pipeline(img[None], cond, **call)
        else:
            frames = pipeline(img[None], **call)

        out_dir = os.path.join(out_root, name)
        written.append(out_dir)
        if not write:
            continue
        os.makedirs(out_dir, exist_ok=True)
        for i, fr in enumerate(frames[0]):
            video_io.write_png(os.path.join(out_dir, f"{i}.png"), fr)
        video_io.export_gif(frames[0], os.path.join(out_dir, "combined.gif"), fps=4)
    return written
