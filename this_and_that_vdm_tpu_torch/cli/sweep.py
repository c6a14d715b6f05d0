"""Sampler / CFG sweep over one instance (counterpart of
``this_and_that_vdm_tpu/cli/sweep.py``).

Runs the VL or VGL pipeline across a grid of step counts, guidance scales,
noise-aug strengths and fps / motion conditioning; records the seconds of
each setting's second call (the first warms up) and, optionally, PSNR / SSIM
against a reference folder of ``0..N.png``.

    python -m this_and_that_vdm_tpu_torch.cli.sweep --random-weights \\
        --instance INSTANCE --steps 15 25 50 --guidance 2.0 3.0 --out sweep.json
"""

from __future__ import annotations

import itertools
import json
import os
import time

import numpy as np
import torch

from ..data.rasterize import load_condition
from ..utils import video_io
from .inference import _load_instance_image, _tokenizer, build_pipeline, parser


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.set_defaults(model_type="UNet")
    p.add_argument("--instance", default=os.path.join("__assets__", "Bridge_example",
                                                      "Task1_v1_511"))
    p.add_argument("--steps", type=int, nargs="+", default=[15, 25, 50])
    p.add_argument("--guidance", type=float, nargs="+", default=[1.5, 3.0])
    p.add_argument("--noise-aug", type=float, nargs="+", default=[0.1])
    p.add_argument("--motion-bucket", type=int, nargs="+", default=[200])
    p.add_argument("--fps", type=int, nargs="+", default=[7])
    p.add_argument("--batch", type=int, default=1, help="clips per call")
    p.add_argument("--reference-dir", default=None,
                   help="dir of 0..N.png to score PSNR/SSIM against")
    p.add_argument("--out", default="sweep_results.json")
    p.add_argument("--save-frames", default=None)
    args = p.parse_args(argv)
    if not args.random_weights and not args.pretrained:
        p.error("either --pretrained <dir> or --random-weights is required")

    pipe = build_pipeline(args)
    tokenize = _tokenizer(args)
    is_gesture = args.model_type == "GestureNet"
    img = np.repeat(_load_instance_image(args.instance, args.height, args.width)[None],
                    args.batch, axis=0)
    lang = os.path.join(args.instance, "lang.txt")
    prompt = ""
    if os.path.exists(lang):
        with open(lang) as f:
            prompt = f.readlines()[0].strip()
    ids = np.repeat(tokenize(prompt), args.batch, axis=0)
    cond = None
    if is_gesture:
        cond, _, _, _ = load_condition(args.instance, (args.height, args.width),
                                       args.num_frames)
    ref_frames = video_io.load_frames_dir(args.reference_dir) if args.reference_dir else None

    results = []
    grid = itertools.product(args.steps, args.guidance, args.noise_aug, args.motion_bucket,
                             args.fps)
    for steps, g, aug, motion, fps in grid:
        call = dict(prompt_ids=ids, num_frames=args.num_frames, num_inference_steps=steps,
                    max_guidance_scale=g, fps=fps, motion_bucket_id=motion,
                    noise_aug_strength=aug, decode_chunk_size=8, output_type="uint8")

        def run():  # the frames come back on the host: the call has finished
            gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
            if is_gesture:
                return pipe(img, cond, generator=gen, **call)
            return pipe(img, generator=gen, **call)

        run()  # warm-up
        t0 = time.perf_counter()
        frames = run()
        dt = time.perf_counter() - t0
        rec = dict(steps=steps, guidance=g, noise_aug=aug, motion=motion, fps=fps,
                   batch=args.batch, device=str(pipe.device), sec_per_call=round(dt, 3),
                   sec_per_clip=round(dt / args.batch, 3))
        if ref_frames is not None:
            m = video_io.per_frame_metrics(list(frames[0]), ref_frames)
            rec.update(psnr_mean=round(m["psnr_mean"], 3), ssim_mean=round(m["ssim_mean"], 4))
        if args.save_frames:
            d = os.path.join(args.save_frames, f"s{steps}_g{g}_a{aug}_m{motion}_f{fps}")
            os.makedirs(d, exist_ok=True)
            for i, fr in enumerate(frames[0]):
                video_io.write_png(os.path.join(d, f"{i}.png"), fr)
        print(rec)
        results.append(rec)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out} ({len(results)} settings)")
    return results


if __name__ == "__main__":
    main()
