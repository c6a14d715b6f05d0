"""This&That demo (the port's counterpart of the repository's root
``app.py``): one image, up to two gesture points ("this" red, "that"
green), a prompt -> a 14-frame clip written as mp4 (GIF where no mp4 writer
is installed).

Without ``--image``: the gradio UI (``launch_gradio``), a resident
pipeline behind ``serving.VideoGenServer``: upload an image, click up to two
points, type a prompt, get an mp4.  With ``--image``: one shot from the
command line.

    python -m this_and_that_vdm_tpu_torch.app --pretrained WEIGHTS \\
        [--image img.jpg --points 120,80 200,160 \\
         --prompt "put the cup on the plate" --out demo.mp4] [--device cpu]

Gesture frame indices are ``[4, 10]`` for two points (reference app.py:159).
The UI needs gradio; without it, and without ``--image``, the command
stops with an error.  Runs on the CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

HEIGHT, WIDTH, FRAMES = 256, 384, 14
GESTURE_FRAME_IDXS = [4, 10]
SAMPLING_DEFAULTS = dict(motion_bucket_id=200, noise_aug_strength=0.1, decode_chunk_size=8,
                         output_type="uint8")


def build_pipeline(pretrained=None, random_weights=False, dtype="bf16", device="cuda"):
    """(VGL pipeline, tokenizer) from an HF-layout tree, or tiny models of
    seeded random weights with the hash tokenizer (``random_weights``); the
    CLI's ``build_pipeline`` bakes it (its weights stay fixed)."""
    from .cli.inference import _tokenizer, build_pipeline as _bp

    args = argparse.Namespace(model_type="GestureNet", pretrained=pretrained,
                              random_weights=random_weights, model_scale=None, dtype=dtype,
                              device=device)
    return _bp(args), _tokenizer(args)


def prepare_inputs(tokenize, image_rgb_uint8, points, prompt):
    """(image [H, W, 3] in [-1, 1], gesture raster [F, H, W, 3], ids [77]) of
    one request; ``points`` are (x, y) in the image's own pixels."""
    from .data.image import resize_bicubic
    from .data.rasterize import rasterize_gesture_points

    oh, ow = image_rgb_uint8.shape[:2]
    gesture = [(GESTURE_FRAME_IDXS[i], float(x), float(y)) for i, (x, y) in enumerate(points[:2])]
    cond = rasterize_gesture_points(gesture, (oh, ow), (HEIGHT, WIDTH), FRAMES)
    img = resize_bicubic(image_rgb_uint8, HEIGHT, WIDTH).astype(np.float32) / 127.5 - 1.0
    return img, np.asarray(cond), np.asarray(tokenize(prompt)).reshape(-1)


def run_generation(pipe, tokenize, image_rgb_uint8, points, prompt, seed=42,
                   num_inference_steps=25):
    """``[F, H, W, 3]`` uint8 frames of one request."""
    img, cond, ids = prepare_inputs(tokenize, image_rgb_uint8, points, prompt)
    frames = pipe(img[None], cond, prompt_ids=ids[None], num_frames=FRAMES,
                  num_inference_steps=num_inference_steps,
                  generator=torch.Generator(device=pipe.device).manual_seed(seed),
                  **SAMPLING_DEFAULTS)
    return frames[0]


POINT_COLORS = [(255, 0, 0), (0, 255, 0)]  # display RGB: this = red, that = green


def draw_points(img, points, radius: int = 8):
    """A copy of ``img`` with a filled disk at each (x, y) point (the
    reference UI's ``cv2.circle(..., -1)``)."""
    vis = img.copy()
    yy, xx = np.mgrid[:img.shape[0], :img.shape[1]]
    for i, (x, y) in enumerate(points):
        disk = (xx - int(x)) ** 2 + (yy - int(y)) ** 2 <= radius * radius
        vis[disk] = POINT_COLORS[min(i, 1)]
    return vis


def launch_gradio(pretrained=None, random_weights=False, dtype="bf16", device="cuda"):
    """The gradio Blocks UI over a resident pipeline: concurrent users with
    the same settings share one pipeline call (``serving.VideoGenServer``)."""
    import gradio as gr

    from .serving import VideoGenServer
    from .utils import video_io

    pipe, tokenize = build_pipeline(pretrained, random_weights, dtype, device)
    server = VideoGenServer(pipe, max_batch=4, max_delay_s=0.25, num_frames=FRAMES,
                            **SAMPLING_DEFAULTS)

    def on_select(img, points, evt):
        points = ((points or []) + [tuple(evt.index)])[:2]
        return draw_points(img, points), points

    # gradio hands the event to the parameter annotated with its type
    on_select.__annotations__["evt"] = gr.SelectData

    def on_clear(img):
        return img, []

    def on_run(orig, points, prompt, seed, steps):
        if orig is None:
            raise gr.Error("upload an image first")
        if not points:
            raise gr.Error("click at least one gesture point")
        img, cond, ids = prepare_inputs(tokenize, orig, points, prompt)
        frames = server.submit(img, condition=cond, prompt_ids=ids, seed=int(seed),
                               num_inference_steps=int(steps)).result()
        # a file of its own a run: concurrent users must not overwrite each
        # other's clip while gradio serves it
        fd, out_path = tempfile.mkstemp(prefix="demo_output_", suffix=".mp4")
        os.close(fd)
        return video_io.export_mp4(frames, out_path)

    with gr.Blocks(title="This&That") as demo:
        gr.Markdown("## This&That: language-gesture video generation")
        points = gr.State([])
        orig = gr.State(None)
        with gr.Row():
            image = gr.Image(label="first frame (click up to 2 points)")
            video = gr.Video(label="generated clip")
        prompt = gr.Textbox(label="prompt", value="put this to there")
        with gr.Row():
            seed = gr.Number(value=42, label="seed")
            steps = gr.Number(value=25, label="steps")
            clear = gr.Button("clear points")
            run = gr.Button("run", variant="primary")
        image.upload(lambda im: (im, im, []), [image], [image, orig, points])
        image.select(on_select, [orig, points], [image, points])
        clear.click(on_clear, [orig], [image, points])
        run.click(on_run, [orig, points, prompt, seed, steps], [video])
    # concurrency, so that simultaneous users reach the batcher together
    demo.queue(default_concurrency_limit=4).launch()
    return server


def main(argv=None):
    from .utils import video_io

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrained", default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--image", default=None, help="input image path")
    p.add_argument("--points", nargs="+", default=[], help="x,y pairs")
    p.add_argument("--prompt", default="put this to there")
    p.add_argument("--out", default="demo_output.mp4")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--device", default="cuda", help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if not args.random_weights and not args.pretrained:
        p.error("either --pretrained <dir> or --random-weights is required")
    if args.image is None:
        try:
            import gradio  # noqa: F401
        except ImportError:
            p.error("gradio is not installed; use the CLI one-shot mode (--image ...)")
        return launch_gradio(args.pretrained, args.random_weights, args.dtype, args.device)

    pipe, tokenize = build_pipeline(args.pretrained, args.random_weights, args.dtype,
                                    args.device)
    img = video_io.read_image(args.image)
    pts = [tuple(map(float, s.split(","))) for s in args.points]
    frames = run_generation(pipe, tokenize, img, pts, args.prompt, args.seed, args.steps)
    out = video_io.export_mp4(frames, args.out)
    print(f"wrote {out} ({len(frames)} frames)")
    return out


if __name__ == "__main__":
    main()
