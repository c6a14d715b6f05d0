"""Batch inference CLI (counterpart of ``this_and_that_vdm_tpu/cli/inference.py``;
the reference's ``test_code/inference.py``).

Walks every instance folder (``im_0.jpg`` + ``lang.txt`` [+ ``data.txt``])
under ``--validation-path``, runs the VL (``--model-type UNet``) or VGL
(``--model-type GestureNet``) pipeline, and writes ``0..13.png`` +
``combined.gif`` + ``lang_cond.txt`` per instance.

Weights come from a local HF-layout directory (``--pretrained``, see
``weights/loader.py``).  ``--random-weights`` runs the full path with tiny
models of seeded random weights, with the md5 hash tokenizer.
``--use-ambiguous-prompt`` rewrites the prompt to "<verb> this to there".
Runs on the CUDA card unless ``--device cpu``.  The pipeline is baked (the
denoise step captured as a CUDA graph and replayed, ``pipelines/svd.py``)
unless ``--no-bake``.

    python -m this_and_that_vdm_tpu_torch.cli.inference --pretrained WEIGHTS \\
        --validation-path INSTANCES --store-dir OUT
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.bridge import ambiguous_prompt
from ..data.image import resize_bicubic
from ..data.rasterize import load_condition
from ..models import cast_compute_dtype
from ..utils import video_io
from ..weights import loader
from .tokenizer import CLIPTokenizer, hash_tokenizer


def _load_instance_image(path: str, height: int, width: int) -> np.ndarray:
    """``im_0.jpg`` as RGB, resized bicubic on uint8 (as cv2 resizes a uint8
    image), scaled to [-1, 1]."""
    img = resize_bicubic(video_io.read_image(os.path.join(path, "im_0.jpg")), height, width)
    return img.astype(np.float32) / 127.5 - 1.0


def build_pipeline(args):
    """``--random-weights``: seeded random models (tiny unless
    ``--model-scale full``); else the ``--pretrained`` tree.  Baked (the
    denoise step a CUDA graph on the card) unless ``--no-bake``."""
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    mode = "vgl" if args.model_type == "GestureNet" else "vl"
    # --model-scale decouples architecture size from weight source, so a
    # synthesized tiny HF-layout tree drives the --pretrained path (the
    # weights rehearsal); --random-weights alone implies tiny
    scale = args.model_scale or ("tiny" if args.random_weights else "full")
    # weights fixed for the whole run: serve baked (--no-bake runs the
    # denoise loop eagerly, e.g. the rehearsal's weight-swap negative control)
    bake = not getattr(args, "no_bake", False)
    if args.random_weights:
        models = loader.random_models(scale, args.device, seed=0)
        for m in models.values():
            cast_compute_dtype(m, dtype)
        return loader.make_pipeline(models, mode, bake_params=bake)
    return loader.load_pretrained(args.pretrained, mode, args.device, dtype, scale,
                                  bake_params=bake)


def _tokenizer(args):
    if args.random_weights:
        return hash_tokenizer()
    tok = CLIPTokenizer.from_pretrained(args.pretrained)
    return lambda s: tok([s])


def execute_inference(args) -> list:
    pipe = build_pipeline(args)
    tokenize = _tokenizer(args)
    is_gesture = args.model_type == "GestureNet"
    os.makedirs(args.store_dir, exist_ok=True)

    outputs = []
    instances = sorted(d for d in os.listdir(args.validation_path)
                       if os.path.isdir(os.path.join(args.validation_path, d)))
    for name in instances:
        inst = os.path.join(args.validation_path, name)
        if not os.path.exists(os.path.join(inst, "im_0.jpg")):
            continue
        if is_gesture and not os.path.exists(os.path.join(inst, "data.txt")):
            print(f"skip {name}: no data.txt")
            continue
        t0 = time.perf_counter()
        image = _load_instance_image(inst, args.height, args.width)[None]
        prompt = ""
        lang = os.path.join(inst, "lang.txt")
        if os.path.exists(lang):
            with open(lang) as f:
                prompt = f.readlines()[0].strip()
        if args.use_ambiguous_prompt:
            prompt = ambiguous_prompt(prompt)
        call = dict(prompt_ids=tokenize(prompt), num_frames=args.num_frames,
                    num_inference_steps=args.num_inference_steps,
                    max_guidance_scale=args.max_guidance_scale, fps=7,
                    motion_bucket_id=args.motion_bucket_id,
                    noise_aug_strength=args.noise_aug_strength,
                    decode_chunk_size=args.decode_chunk_size,
                    generator=torch.Generator(device=pipe.device).manual_seed(args.seed),
                    output_type="uint8")
        if is_gesture:
            cond, _, _, _ = load_condition(inst, (args.height, args.width), args.num_frames)
            frames = pipe(image, cond, controlnet_conditioning_scale=1.0, **call)
        else:
            frames = pipe(image, **call)

        out_dir = os.path.join(args.store_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        for i, fr in enumerate(frames[0]):
            video_io.write_png(os.path.join(out_dir, f"{i}.png"), fr)
        video_io.export_gif(frames[0], os.path.join(out_dir, "combined.gif"), fps=4)
        with open(os.path.join(out_dir, "lang_cond.txt"), "w") as f:
            f.write(prompt + "\n")
        print(f"{name}: wrote {len(frames[0])} frames -> {out_dir} "
              f"({time.perf_counter() - t0:.3f} s)")
        outputs.append(out_dir)
    return outputs


def parser(description=__doc__):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model-type", "--model_type", dest="model_type",
                   choices=["UNet", "GestureNet"], default="GestureNet")
    p.add_argument("--pretrained", default=None,
                   help="local dir with HF-layout subfolders (see weights/loader.py)")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random models (no checkpoint needed; tiny unless --model-scale)")
    p.add_argument("--model-scale", choices=["full", "tiny"], default=None,
                   help="architecture size (default: full; tiny with --random-weights); "
                        "'tiny' lets --pretrained load a synthesized tiny tree")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    p.add_argument("--no-bake", action="store_true",
                   help="run the denoise loop eagerly instead of replaying the step's "
                        "CUDA graph (captured once per shape, its weights' addresses "
                        "baked in)")
    return p


def main(argv=None):
    p = parser()
    p.add_argument("--validation-path", "--validation_path", dest="validation_path",
                   default=os.path.join("__assets__", "Bridge_example"))
    p.add_argument("--store-dir", "--parent_store_folder", dest="store_dir",
                   default="inference_results")
    p.add_argument("--use-ambiguous-prompt", "--use_ambiguous_prompt",
                   dest="use_ambiguous_prompt", action="store_true")
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--max-guidance-scale", type=float, default=3.0)
    p.add_argument("--motion-bucket-id", type=int, default=200)
    p.add_argument("--noise-aug-strength", type=float, default=0.1)
    p.add_argument("--decode-chunk-size", type=int, default=8)
    args = p.parse_args(argv)
    if not args.random_weights and not args.pretrained:
        p.error("either --pretrained <dir> or --random-weights is required")
    return execute_inference(args)


if __name__ == "__main__":
    main()
