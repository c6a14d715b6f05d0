"""The reference's work at a cell's shapes, counted once a process (see
``flops``): operations of a served clip and of a train step, and the least
time of the calls that the program routes to its own kernels."""

from __future__ import annotations

import functools
import json

from . import flops, peaks


def _sizes(config: dict) -> str:
    return json.dumps(config["models"], sort_keys=True)


@functools.lru_cache(maxsize=None)
def _step(sizes_json: str, rows: int, frames: int, h: int, w: int, controlnet: bool):
    return flops.denoise_step(json.loads(sizes_json), rows, frames, h, w, controlnet)


def denoise_step(config: dict, clips: int):
    """(FLOPs, kernel-site calls) of one denoise step of ``clips`` clips."""
    s = config["sampling"]
    return _step(_sizes(config), 2 * clips, s["num_frames"], s["height"] // 8, s["width"] // 8,
                 config["mode"] == "vgl")


@functools.lru_cache(maxsize=None)
def _clip_flops(config_json: str) -> float:
    config = json.loads(config_json)
    s = config["sampling"]
    edges, _ = flops.clip_edges(config["models"], 1, s["num_frames"], s["height"], s["width"],
                                s["decode_chunk_size"], config["mode"] == "vgl")
    return s["num_inference_steps"] * denoise_step(config, 1)[0] + edges


def clip_flops(config: dict) -> float:
    """FLOPs of one served clip: the denoise loop, the encodes, the decode."""
    return _clip_flops(json.dumps(config, sort_keys=True))


def step_bound_s(config: dict, clips: int, kind: str) -> float:
    """Least seconds of one denoise step's ``kind`` calls (``ln_matmul`` or
    ``groupnorm``) in bf16."""
    calls = denoise_step(config, clips)[1]
    if kind == "ln_matmul":
        return sum(peaks.ln_matmul_bound_s(r, c, n, 2, peaks.BF16_FLOPS)
                   for k, r, c, n in (x for x in calls if x[0] == kind))
    return sum(peaks.groupnorm_bound_s(x[1], 2) for x in calls if x[0] == kind)


@functools.lru_cache(maxsize=None)
def _train(config_json: str):
    config = json.loads(config_json)
    s = config["batch"]
    return flops.vl_train_step(config["models"], s["num_frames"], s["height"], s["width"],
                               bool(config["train"]["gradient_checkpointing"]))


def train_step(config: dict):
    """(UNet forward + backward FLOPs, frozen-encode FLOPs, the kernel-site
    calls of the forward and of the recompute) of one VL step at batch 1."""
    return _train(json.dumps(config, sort_keys=True))
