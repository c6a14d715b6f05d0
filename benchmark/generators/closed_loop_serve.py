"""Closed-loop clients of the served clip pipeline.

Traffic parameters (``traffic/<name>.json``): ``clients`` closed-loop
clients, each sending its next request as soon as the last is answered;
the server's ``max_batch`` and ``max_delay_s``; ``two_point_share``, the
share of requests whose gesture has a second point; ``check_clips``, the
clips of the window that the reference recomputes.

Every request is drawn from the run's seed, the client and its index: a
smooth random image, 77 prompt ids, a gesture raster of one or two points
(the first at frame 0, the second at the last frame, positions uniform)
and the seed of its own noise.  The system under test is the program's
``VideoGenServer`` over its baked pipeline (``weights.loader.make_pipeline``
with ``bake_params=True``), at the configuration's sizes, with seeded
weights cast by the program's ``cast_compute_dtype``.

Set-up warms the cell's own shapes with one call at the cell's batch (which
captures the step graph), then the window opens.  After the window the
program is freed and the reference recomputes ``check_clips`` clips drawn
from the seed among those the window completed, from the same inputs and
weights, in fp32.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import stats, trace, weights
from benchmark.reference import ops as ref_ops
from benchmark.reference import pipeline as ref_pipeline

MODELS = ("unet", "gesturenet", "vae", "image_encoder", "text_encoder")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def request(seed: int, client: int, index: int, s: dict, traffic: dict) -> dict:
    """The inputs of request ``index`` of ``client`` (client -1: warm-up)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, client + 1, index])
    h, w, f = s["height"], s["width"], s["num_frames"]
    low = torch.from_numpy(rng.uniform(-1, 1, (1, 3, h // 32 + 1, w // 32 + 1)).astype(np.float32))
    image = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=True)[0]
    image = image.permute(1, 2, 0).numpy()
    image = np.clip(image + 0.05 * rng.standard_normal((h, w, 3), np.float32), -1, 1)
    n_points = 2 if rng.random() < traffic["two_point_share"] else 1
    points = [(0 if i == 0 else f - 1, rng.uniform(0, w), rng.uniform(0, h))
              for i in range(n_points)]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    raster = np.zeros((f, h, w, 3), np.float32)
    colors = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0))
    for i, (frame, x, y) in enumerate(points):
        m = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0 ** 2))[..., None]
        raster[frame] = (1.0 - m) + m * np.asarray(colors[i], np.float32)
    length = int(rng.integers(4, 40))
    ids = np.zeros(77, np.int64)
    ids[0], ids[1:length + 1], ids[length + 1] = 49406, rng.integers(0, 49406, length), 49407
    return dict(image=image.astype(np.float32), condition=raster, prompt_ids=ids,
                seed=int(rng.integers(0, 2 ** 62)))


def port_models(sizes: dict, seed: int, device, dtype) -> dict:
    """The program's five models holding the seeded weights, cast to the
    compute dtype by the program's ``cast_compute_dtype``."""
    from this_and_that_vdm_tpu_torch.models import cast_compute_dtype
    from this_and_that_vdm_tpu_torch.models.clip import (CLIPTextModel,
                                                          CLIPVisionModelWithProjection)
    from this_and_that_vdm_tpu_torch.models.controlnet import ControlNetModel
    from this_and_that_vdm_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from this_and_that_vdm_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
    from this_and_that_vdm_tpu_torch.weights import loader

    classes = dict(unet=UNetSpatioTemporalConditionModel, gesturenet=ControlNetModel,
                   vae=AutoencoderKLTemporalDecoder, image_encoder=CLIPVisionModelWithProjection,
                   text_encoder=CLIPTextModel)
    defaults = loader.model_configs("full")
    out = {}
    for name in sizes:
        if name not in classes:
            continue
        base = defaults[name]
        cfg = dataclasses.replace(base, **{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in sizes[name].items()
                                           if k in base.__dataclass_fields__})
        with torch.device("meta"):
            model = classes[name](cfg)
        state, buf = weights.draw(name, sizes[name], seed, device)
        model.load_state_dict(state, strict=True, assign=True)
        if dtype is not None:
            cast_compute_dtype(model, dtype)
        for p in model.parameters():  # no view of the drawn buffer stays
            p.data = p.data.clone()
        del state, buf
        out[name] = model.eval().requires_grad_(False)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host seconds of the pipeline's stages (the traced run: each stage
    synchronised at both ends and recorded as a profiler span)."""

    STAGES = ("encode_conditioning", "encode_condition_img", "_denoise_loop", "_finish")

    def __init__(self, pipe, device):
        self.seconds = {k: [] for k in self.STAGES}
        self.intervals = {}  # stage -> [(start_ns, end_ns)], for the profile
        self.denoise_batches = []
        for stage in self.STAGES:
            setattr(pipe, stage, self._wrap(getattr(pipe, stage), stage, device))

    def _wrap(self, fn, stage, device):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with trace.span(stage, device, self.intervals):
                out = fn(*args, **kwargs)
            self.seconds[stage].append(time.perf_counter() - t0)
            if stage == "_denoise_loop":
                self.denoise_batches.append(int(args[1].shape[0]))
            return out

        return wrapped


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    from this_and_that_vdm_tpu_torch.serving.server import VideoGenServer
    from this_and_that_vdm_tpu_torch.weights import loader

    cfg, traffic = cell.config, cell.traffic
    s, sizes = cfg["sampling"], cfg["models"]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    models = port_models(sizes, seed, device, DTYPES[cfg["compute_dtype"]])
    pipe = loader.make_pipeline(models, cfg["mode"], bake_params=True)
    sampling = {k: s[k] for k in ("num_frames", "num_inference_steps", "min_guidance_scale",
                                  "max_guidance_scale", "fps", "motion_bucket_id",
                                  "noise_aug_strength", "decode_chunk_size",
                                  "controlnet_conditioning_scale")}
    server = VideoGenServer(pipe, max_batch=traffic["max_batch"],
                            max_delay_s=traffic["max_delay_s"], output_type="uint8", **sampling)

    def submit(req):
        return server.submit(req["image"], condition=req["condition"],
                             prompt_ids=req["prompt_ids"], seed=req["seed"])

    # warm-up: one call at the cell's batch (captures the step's graph)
    warm = [request(seed, -1, i, s, traffic) for i in range(traffic["max_batch"])]
    for fut in [submit(req) for req in warm]:
        fut.result()
    sync(device)
    captures = pipe.captures
    spans = Spans(pipe, device) if traced else None
    first = [request(seed, c, 0, s, traffic) for c in range(traffic["clients"])]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = trace.Profile() if traced else None
    setup_s = time.perf_counter() - t_start

    records, errors, lock = [], [], threading.Lock()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    if prof is not None:
        prof.start()

    def client(c):
        j, req = 0, first[c]
        while time.perf_counter() < deadline:
            t_sub = time.perf_counter()
            fut = submit(req)
            nxt = request(seed, c, j + 1, s, traffic)
            try:
                out = fut.result()
            except Exception as e:  # noqa: BLE001 - a failed request counts as failed
                with lock:
                    errors.append(repr(e))
                out = None
            t_done = time.perf_counter()
            with lock:
                records.append(dict(client=c, index=j, t_submit=t_sub, t_done=t_done,
                                    timing=getattr(fut, "timing", None), frames=out))
            j, req = j + 1, nxt

    threads = [threading.Thread(target=client, args=(c,)) for c in range(traffic["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if prof is not None:
        prof.stop()
    window_s, n_done = stats.close_window(t_open, deadline, [r["t_done"] for r in records])
    inside = [r for r in records if r["t_done"] <= deadline and r["frames"] is not None]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    graphs = pipe.step_graphs()
    replays = sum(g.replays for g in graphs) if device.type == "cuda" else 0
    server.close()
    # on the card the window replays the graphs that set-up captured
    captures_ok = (captures > 0) == (device.type == "cuda")
    window_captures = pipe.captures - captures

    # the reference, once the program is freed
    checked = pick_checked(inside, traffic["check_clips"], seed)
    del pipe, server, models, graphs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = {name: weights.reference_model(name, sizes[name], seed, device) for name in MODELS}
    worst = 0.0
    for r in checked:
        want = reference_frames(ref, request(seed, r["client"], r["index"], s, traffic), s,
                                device)
        worst = max(worst, frame_rmse(r["frames"], want))
    reference_s = time.perf_counter() - t_ref
    del ref

    latencies = [r["t_done"] - r["t_submit"] for r in inside]
    timings = [r["timing"] for r in inside if r["timing"]]
    readings = dict(
        setup_s=setup_s, window_s=window_s, completed=n_done, latencies=latencies,
        queue_s=[t["queue_s"] for t in timings], batches=[t["batch"] for t in timings],
        peak_bytes=peak, captures=captures, replays=replays, config=cfg, traffic=traffic,
        attempted=len(records), failed=len(errors),
        correct=bool(checked) and not errors and captures_ok,
        compared={"frame_rmse": {"value": worst, "limit": cfg["limits"]["frame_rmse"]}},
        device=device_info(device, peak),
        notes=dict(latency_samples=len(latencies), calls=len(spans.denoise_batches)
                   if spans is not None else None, captures=captures,
                   window_captures=window_captures, replays=replays,
                   checked=len(checked), reference_s=round(reference_s, 3), errors=errors[:3]))
    if spans is not None:
        readings["stage_s"] = spans.seconds
        readings["denoise_batches"] = spans.denoise_batches
    if prof is not None:
        summary = prof.summary(spans.intervals)
        readings["summary"] = summary
        readings["device"].update(busy_s=summary.busy_s(), window_s=summary.window_s)
        readings["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    return readings


CALL_GAP_S = 0.25


def pick_checked(records: list, n: int, seed: int) -> list:
    """``n`` clips of the window for the reference, drawn from the seed: all
    from one pipeline call drawn at random among the largest, spread over
    its halves, so that a call that serves half its clips wrongly shows; at
    batch 1, from distinct calls."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    # a call's requests share its start, submit + queue wait, up to the time that
    # submit() itself takes; calls start at least a call's length apart
    start = lambda r: r["t_submit"] + r["timing"]["queue_s"]  # noqa: E731
    calls = []
    for r in sorted(records, key=start):
        if calls and start(r) - start(calls[-1][-1]) < CALL_GAP_S:
            calls[-1].append(r)
        else:
            calls.append([r])
    largest = max((len(c) for c in calls), default=0)
    if largest < 2:
        idx = rng.choice(len(records), min(n, len(records)), replace=False)
        return [records[i] for i in sorted(idx.tolist())]
    group = sorted(calls[rng.choice([i for i, c in enumerate(calls) if len(c) == largest])],
                   key=lambda r: r["t_submit"])  # the server takes a call's requests in order
    halves = np.array_split(np.arange(largest), min(n, largest))
    return [group[int(rng.choice(h))] for h in halves]


def reference_frames(ref: dict, req: dict, s: dict, device, precision: str = "fp32"):
    """The reference's uint8 frames of one request (TF32 off)."""
    with ref_ops.no_tf32(), ref_ops.precision(precision):
        return ref_pipeline.vgl_clip(
            ref, torch.from_numpy(req["image"]).to(device),
            torch.from_numpy(req["condition"]).to(device),
            torch.from_numpy(req["prompt_ids"]).to(device), req["seed"], s).cpu().numpy()


def frame_rmse(got, want) -> float:
    """The worst frame's root mean square difference, in uint8 levels."""
    if got is None or got.shape != want.shape or got.dtype != want.dtype:
        return float("inf")
    diff = got.astype(np.float64) - want.astype(np.float64)
    return float(np.sqrt((diff ** 2).mean(axis=(1, 2, 3))).max())


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}
