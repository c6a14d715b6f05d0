"""VL inference pipeline: image (+ text) -> video (counterpart of
``pipelines/svd.py``).

Conditioning encode (CLIP vision + text, joint LayerNorm, VAE encode of the
noise-augmented first frame), a Python loop of Euler-EDM steps with the CFG
pair as batch 2 and per-frame linspace guidance, chunked temporal-VAE decode,
postprocess.  Random draws come from an explicit ``torch.Generator``;
``latents=`` and ``image_noise=`` inject them instead (the tests hand both
packages the same numpy draws).

Spans (``utils.profiling``, recorded while a profiler runs or inside
``profiling.recording()``): ``pipeline.call`` over a call, and inside it,
each opened in the method that does the stage, ``pipeline.cond_encode``
(``encode_conditioning``), ``pipeline.gesture_encode``
(``encode_condition_img``), ``denoise.replay`` (``StepGraph.run``: events
before the first replay and after the last) or ``denoise.eager`` (the eager
and the CFG-split loops), ``pipeline.decode`` and ``pipeline.to_host``
(``_finish``), each with a device interval (timing events, no
synchronise), and ``pipeline.capture`` (a step graph's warm-up call and
capture).  ``trace``: an optional dict; when given, the same
stage spans end in a device synchronise and their wall seconds go under
``cond_encode``, ``gesture_encode``, ``denoise``, ``decode`` and
``uint8_host``, with the final latents under ``latents``.

``place_on_mesh(mesh)`` serves over a (clip, cfg) serving mesh
(``parallel.make_serving_mesh``): one replica of each model per distinct
device; a call's clips are split over ``clip`` (each part from its own
first device: encode, denoise, decode), and in the denoise loop the CFG
branches over ``cfg`` when it equals their count (2; 3 with ip2p; otherwise
every branch runs on the part's first device).  Each step the branches'
noise predictions meet on the first device for the guided combine, and the
new latents go back to every branch.

The single-device denoise loop (every loop but the CFG-split one) runs one
step function, :func:`denoise_step` (the JAX scan body), over a
``[steps, 8]`` fp32 table of each step's scalars on the device
(:func:`denoise_table`).  ``bake_params`` (default False, as in the JAX
dataclass; the CLI and the app turn it on) runs it as a CUDA graph on a
CUDA pipeline: the step is captured once a key (:class:`StepGraph`, the
counterpart of the JAX package's cached ``jit(lax.scan)``, its weights'
addresses baked in) and then replayed once a step after a copy of the
step's row; the programs are cached per pipeline (``_cached_fn``, at most
``_FN_CACHE_LIMIT``, oldest evicted first).  The key (``_step_key``) holds
everything the graph bakes in: the kind (``denoise`` / ``denoise_cn``),
the latents' shape (batch, frames, h, w), the compute dtype, the device,
``ip2p``, ``guess_mode``, the shapes of the step's inputs and
(``_bake_key``) the ``data_ptr`` of every parameter and buffer of the UNet
and the ControlNet: reassigning a tensor captures anew, while an in-place
``copy_`` or ``load_state_dict`` keeps the key and the graph reads the new
values.  Unlike the JAX key, ``num_steps``, ``control_guidance_start/end``
and the guidance scales are not in it: they are rows and columns of the
table.  Unbaked, and on the CPU (which has no graphs), the same step runs
eagerly, so baked and eager latents are equal bit for bit.  A capture or
replay that fails raises; nothing falls back to the eager loop.  Leave
``bake_params`` off where weights change between calls by reassignment or
are freed at rest (training's validation renders, ZeRO-3 units).  The
CFG-split loop on a serving mesh stays eager.
"""

from __future__ import annotations

import copy
import functools
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import ops, parallel
from ..models.transformer import CfgBranch
from ..schedulers import make_svd_schedule, table_scale_model_input, table_step
from ..schedulers.euler_discrete import DT, T
from ..utils import profiling
from . import common

# columns the pipelines add to the scheduler's step table: the ControlNet's
# scale at the step (controlnet_conditioning_scale times the step's
# control_guidance gate) and the ip2p image guidance scale
CN_SCALE, IMG_SCALE = DT + 1, DT + 2


def denoise_table(num_steps: int, device, cn_scale=None, image_guidance_scale: float = 0.0):
    """``([num_steps, 8] fp32 table on ``device``, init_noise_sigma)``: the
    scheduler's ``step_table`` and the columns ``CN_SCALE`` (``cn_scale``, a
    value a step) and ``IMG_SCALE``, built once a call."""
    sched = make_svd_schedule(num_steps)
    extra = np.zeros((num_steps, 2), np.float32)
    if cn_scale is not None:
        extra[:, 0] = cn_scale
    extra[:, 1] = image_guidance_scale
    table = np.concatenate([sched.step_table(), extra], axis=1)
    return torch.from_numpy(table).to(device), sched.init_noise_sigma


def denoise_step(unet, controlnet, x, row, inputs: dict, ip2p: bool = False,
                 guess_mode: bool = False):
    """One Euler step of the CFG-folded single-device loop (the JAX scan
    body): ``x`` the latents ``[B, F, h, w, 4]`` fp32, ``row`` the step's row
    of :func:`denoise_table` on the device, ``inputs`` what every step reads:
    ``states`` and ``add_ids`` (CFG-folded), ``img_lat`` ``[mult * B, h, w,
    4]``, ``guidance`` ``[B, F, 1, 1, 1]`` and, with a ControlNet,
    ``cn_cond`` (``[B, F, h, w, 4]`` in guess mode, else ``[mult * B, ...]``).
    ``controlnet`` None: the VL step.  Guess mode runs the ControlNet on the
    conditional branch alone (last in the standard ``[uncond; cond]``
    layout, first in ip2p ``[cond; uncond_t; uncond_i]``) and pads the other
    branches' residuals with zeros.  Reads no host value: it is what a
    :class:`StepGraph` captures."""
    b, f = x.shape[:2]
    mult = 3 if ip2p else 2
    with profiling.annotate("step.model_input"):
        img_lat = inputs["img_lat"][:, None].expand(-1, f, -1, -1, -1)
        inp = torch.cat([table_scale_model_input(torch.cat([x] * mult, dim=0), row), img_lat],
                        dim=-1)
    t, states, ids = row[T], inputs["states"], inputs["add_ids"]
    res = mid = None
    if controlnet is not None and guess_mode:
        rows = slice(0, b) if ip2p else slice(b * (mult - 1), b * mult)
        res, mid = controlnet(inp[rows], t, states[rows], ids[rows], inputs["cn_cond"],
                              conditioning_scale=row[CN_SCALE], guess_mode=True,
                              context_clips=b)

        def pad(r):
            zeros = [torch.zeros_like(r)] * (mult - 1)
            return torch.cat([r] + zeros if ip2p else zeros + [r], dim=0)

        res, mid = tuple(pad(r) for r in res), pad(mid)
    elif controlnet is not None:
        res, mid = controlnet(inp, t, states, ids, inputs["cn_cond"],
                              conditioning_scale=row[CN_SCALE], context_clips=b)
    pred = unet(inp, t, states, ids, down_block_additional_residuals=res,
                mid_block_additional_residual=mid, context_clips=b)
    guidance = inputs["guidance"]
    with profiling.annotate("step.guidance_update"):
        if ip2p:
            p_first, p_cond, p_uncond = pred.chunk(3, dim=0)
            pred = (p_uncond + guidance * (p_cond - p_uncond)
                    + row[IMG_SCALE] * (p_cond - p_first))
        else:
            p_uncond, p_cond = pred.chunk(2, dim=0)
            pred = p_uncond + guidance * (p_cond - p_uncond)
        return table_step(pred, row, x)


class StepGraph:
    """``step(x, row, inputs)`` captured as one CUDA graph over static
    buffers (the latents, the step's row, the inputs), after one warm-up
    call on the capture's side stream (lazy library state must not start
    inside a capture).  The graph writes the new latents back into its
    latents buffer, so :meth:`run` is a copy of the step's row and a replay,
    once a step.  ``launches``: the kernel launches the capture recorded
    (the wrappers counted them while capturing, and nothing ran then, so
    they are taken off the counters and added back on every replay).
    Temporaries live in ``pool``, which the graphs of one pipeline share:
    their replays never overlap.  Nothing catches a failed capture.  One
    graph a step rather than one for the loop: the host enqueues the
    replays ahead of the device, so a loop graph would save only the row
    copies, at the loop's length times the capture."""

    def __init__(self, step, x, row, inputs: dict, pool):
        dev = x.device
        with torch.cuda.device(dev), profiling.span("pipeline.capture", batch=x.shape[0]):
            self.x, self.row = x.clone(), row.clone()
            self.inputs = {k: v.clone() for k, v in inputs.items()}
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                step(self.x, self.row, self.inputs)
            torch.cuda.current_stream(dev).wait_stream(stream)
            before = ops.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.x.copy_(step(self.x, self.row, self.inputs))
            self.capture_s = time.perf_counter() - t0
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.replays = 0

    def run(self, x, table, inputs: dict, trace: Optional[dict] = None):
        """The loop from latents ``x`` over the rows of ``table`` -> the
        final latents (a new tensor); the replays inside ``denoise.replay``."""
        steps = table.shape[0]
        with torch.cuda.device(self.x.device):
            for k, v in inputs.items():
                self.inputs[k].copy_(v)
            self.x.copy_(x)
            with profiling.span("denoise.replay", self.x.device, trace=trace, key="denoise",
                                steps=steps, batch=self.x.shape[0]):
                for i in range(steps):
                    self.row.copy_(table[i])
                    self.graph.replay()
                    ops.add_launch_counts(self.launches)
            self.replays += steps
            return self.x.clone()


def cfg_parts(branches, b: int, rows: dict):
    """The CFG branches of one clip part, a branch a replica: ``(replica,
    its rows of each tensor of ``rows`` (branch-major blocks of ``b``), on
    its device, and its ``CfgBranch``)``; ``rows["states"]`` are the encoder
    states of the whole folded batch."""
    out = []
    for j, pipe in enumerate(branches):
        dev = pipe.device
        part = {k: v[j * b:(j + 1) * b].to(dev) for k, v in rows.items()}
        out.append((pipe, part, CfgBranch(b, j, len(branches), rows["states"].to(dev))))
    return out


class StableVideoDiffusionPipeline:
    """Holds the modules; ``__call__`` mirrors the reference API."""

    _MODULES = ("unet", "vae", "image_encoder", "text_encoder")
    _FN_CACHE_LIMIT = 8  # graphs (with their static buffers) kept at most

    def __init__(self, unet, vae, image_encoder, text_encoder=None, bake_params: bool = False):
        self.unet, self.vae = unet, vae
        self.image_encoder, self.text_encoder = image_encoder, text_encoder
        self.bake_params = bake_params
        self.mesh = None
        self._replicas = {}
        self._own_cache()

    def _own_cache(self):
        """A program cache, graph pool, capture count and lock of this
        pipeline's own (a mesh replica gets new ones)."""
        self._fn_cache, self._graph_pool = {}, None
        self.captures = 0  # step graphs captured, over every key
        self._lock = threading.Lock()

    def _cached_fn(self, key, build):
        """The cached program of ``key``, built by ``build()`` if absent; at
        most ``_FN_CACHE_LIMIT`` kept, the oldest evicted first."""
        entry = self._fn_cache.get(key)
        if entry is None:
            entry = build()
            while len(self._fn_cache) >= self._FN_CACHE_LIMIT:
                self._fn_cache.pop(next(iter(self._fn_cache)))
            self._fn_cache[key] = entry
        return entry

    def step_graphs(self) -> list:
        """The cached :class:`StepGraph` objects, oldest first."""
        return list(self._fn_cache.values())

    @staticmethod
    def _tensor_identity(module):
        """The ``data_ptr`` of every parameter and buffer of ``module`` (the
        counterpart of the JAX ``_tree_identity``): the addresses a graph
        reads.  An address that comes back holds the tensor now there, which
        is what a graph keyed by it reads, so no old tensor is retained."""
        if module is None:
            return None
        return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))

    def _bake_key(self):
        if not self.bake_params:
            return None
        return (self._tensor_identity(self.unet),
                self._tensor_identity(getattr(self, "controlnet", None)))

    def _step_key(self, kind: str, x, inputs: dict, ip2p: bool, guess_mode: bool):
        return (kind, tuple(x.shape), self.unet.conv_in.weight.dtype, x.device, ip2p, guess_mode,
                tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items())),
                self._bake_key())

    def _denoise_loop(self, kind: str, latents, table, init_noise_sigma: float, inputs: dict,
                      ip2p: bool = False, guess_mode: bool = False,
                      trace: Optional[dict] = None):
        """The single-device loop: :func:`denoise_step` over the rows of
        ``table``, replayed from a cached :class:`StepGraph` when baked on a
        CUDA device, else called eagerly (``denoise.eager``)."""
        controlnet = self.controlnet if kind == "denoise_cn" else None
        step = functools.partial(denoise_step, self.unet, controlnet, ip2p=ip2p,
                                 guess_mode=guess_mode)
        x = latents * init_noise_sigma
        if not (self.bake_params and x.device.type == "cuda"):
            with profiling.span("denoise.eager", x.device, trace=trace, key="denoise",
                                steps=table.shape[0], batch=x.shape[0]):
                for i in range(table.shape[0]):
                    x = step(x, table[i], inputs)
            return x
        with self._lock:
            def build():
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                self.captures += 1
                return StepGraph(step, x, table[0], inputs, self._graph_pool)

            graph = self._cached_fn(self._step_key(kind, x, inputs, ip2p, guess_mode), build)
            return graph.run(x, table, inputs, trace)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def place_on_mesh(self, mesh):
        """Serve over a (clip, cfg) serving mesh (see the module docstring);
        replicas are made here, once.  Returns ``self``."""
        copies = {name: parallel.replicate_to_mesh(getattr(self, name), mesh)
                  for name in self._MODULES if getattr(self, name) is not None}
        self._replicas = {}
        for dev in {d for reps in copies.values() for d in reps}:
            rep = copy.copy(self)
            for name, reps in copies.items():
                setattr(rep, name, reps[dev])
            rep.mesh, rep._replicas = None, {}
            rep._own_cache()
            self._replicas[dev] = rep
        self.mesh = mesh
        self._fn_cache.clear()
        return self

    def _replica(self, dev) -> "StableVideoDiffusionPipeline":
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return self._replicas[dev]

    def _serve(self, run, per_clip: dict, shared: dict, output_type: str,
               decode_chunk_size: int, trace):
        """``run(lead, branches, **inputs) -> latents`` on each clip part
        (the whole batch without a mesh), then decode; ``per_clip`` tensors
        are split over ``clip``, ``shared`` ones go whole to each part."""
        if self.mesh is None:
            parts = [(self, [self], dict(per_clip, **shared), trace)]
        else:
            split = {k: parallel.shard_leading(v, self.mesh, ("clip",))
                     for k, v in per_clip.items()}
            parts = []
            for c, lead_dev in enumerate(parallel.mesh_devices(self.mesh, ("clip",))):
                inputs = {k: v[c] for k, v in split.items()}
                if next(iter(inputs.values())).shape[0] == 0:
                    continue  # fewer clips than the clip axis
                branches = [self._replica(d) for d in self.mesh.devices[c]]
                inputs.update({k: None if v is None else v.to(lead_dev)
                               for k, v in shared.items()})
                parts.append((branches[0], branches, inputs, None if trace is None else {}))
        lats, outs = [], []
        for lead, branches, inputs, tr in parts:
            x = run(lead, branches, trace=tr, **inputs)
            lats.append(x)
            if output_type != "latent":
                outs.append(lead._finish(x, output_type, decode_chunk_size, tr))
            if tr is not None and tr is not trace:  # a part's stages add up
                for k, v in tr.items():
                    trace[k] = trace.get(k, 0.0) + v
        if trace is not None:
            trace["latents"] = torch.cat([x.to(self.device) for x in lats])
        if output_type == "latent":
            return torch.cat([x.cpu() for x in lats]).numpy()
        return np.concatenate(outs)

    def _draws(self, image, generator, image_noise, latents, num_frames):
        """Inputs as fp32 tensors on the device; missing noise drawn from
        ``generator`` (image noise first, then latents)."""
        dev = self.device
        image = torch.as_tensor(image, device=dev).float()
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        b, h, w = image.shape[:3]
        if image_noise is None:
            image_noise = torch.randn(image.shape, generator=generator, device=dev)
        if latents is None:
            latents = torch.randn((b, num_frames, h // 8, w // 8, 4), generator=generator,
                                  device=dev)
        return (image, torch.as_tensor(image_noise, device=dev).float(),
                torch.as_tensor(latents, device=dev).float())

    def encode_conditioning(self, image_m11, input_ids, noise_img, mode: str = "standard",
                            trace: Optional[dict] = None):
        """-> (encoder states with CFG batching, image latents with CFG batching)."""
        with profiling.span("pipeline.cond_encode", self.device, trace=trace):
            px = common.clip_preprocess(image_m11)
            image_embeds = self.image_encoder(px)
            text_states = None
            if self.text_encoder is not None and input_ids is not None:
                text_states = self.text_encoder(input_ids)
            states = common.build_encoder_hidden_states(image_embeds, text_states)
            lat = self.vae.encode_mode(image_m11 + noise_img).float()
            if mode == "ip2p":
                return (common.cfg_concat(states, "ip2p_states"),
                        common.cfg_concat(lat, "ip2p_image"))
            return common.cfg_concat(states), common.cfg_concat(lat)

    def _finish(self, latents, output_type: str, decode_chunk_size: int, trace):
        with profiling.span("pipeline.decode", self.device, trace=trace):
            frames = common.decode_latents_chunked(
                self.vae.decode, latents, self.vae.config.scaling_factor, decode_chunk_size)
        with profiling.span("pipeline.to_host", self.device, trace=trace, key="uint8_host"):
            if output_type == "uint8":
                out = common.postprocess_frames_uint8(frames).cpu().numpy()
            else:
                out = common.postprocess_frames(frames).cpu().numpy()
        return out

    @torch.no_grad()
    def __call__(self, image, prompt_ids=None, num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0,
                 max_guidance_scale: float = 3.0, fps: int = 7, motion_bucket_id: int = 127,
                 noise_aug_strength: float = 0.02, decode_chunk_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, latents=None,
                 image_noise=None, output_type: str = "np", trace: Optional[dict] = None):
        """``image`` [B, H, W, 3] in [-1, 1]; ``prompt_ids`` [B, 77] int."""
        with profiling.span("pipeline.call", batch=len(image)):
            dev = self.device
            decode_chunk_size = decode_chunk_size or num_frames
            image, image_noise, latents = self._draws(image, generator, image_noise, latents,
                                                      num_frames)
            ids = None if prompt_ids is None else torch.as_tensor(prompt_ids, device=dev)
            per_clip = dict(image=image, image_noise=image_noise, latents=latents)
            if ids is not None:
                per_clip["ids"] = ids

            def run(pipe, branches, image, image_noise, latents, ids=None, trace=None):
                return pipe._generate(branches, image, ids, image_noise, latents, num_frames,
                                      num_inference_steps, min_guidance_scale,
                                      max_guidance_scale, fps, motion_bucket_id,
                                      noise_aug_strength, trace)

            return self._serve(run, per_clip, {}, output_type, decode_chunk_size, trace)

    def _generate(self, branches, image, ids, image_noise, latents, num_frames, steps,
                  min_guidance_scale, max_guidance_scale, fps, motion_bucket_id,
                  noise_aug_strength, trace):
        """Encode and denoise the clips of one part -> final latents."""
        dev = self.device
        b = image.shape[0]
        states_cfg, img_lat_cfg = self.encode_conditioning(
            image, ids, noise_aug_strength * image_noise, trace=trace)
        add_ids = common.get_add_time_ids(fps - 1, motion_bucket_id, noise_aug_strength,
                                          b, 2, dev)
        guidance = common.guidance_linspace(min_guidance_scale, max_guidance_scale,
                                            num_frames, b, dev)
        if len(branches) == 2:  # the cfg axis: a branch a device (eager)
            sched = make_svd_schedule(steps)
            img_lat = img_lat_cfg[:, None].expand(-1, num_frames, -1, -1, -1)
            x = latents * sched.init_noise_sigma
            parts = cfg_parts(branches, b, dict(states=states_cfg, img_lat=img_lat,
                                                add_ids=add_ids))
            with profiling.span("denoise.eager", dev, trace=trace, key="denoise", steps=steps,
                                batch=b, branches=len(branches)):
                for i in range(steps):
                    preds = []
                    for pipe, rows, ctx in parts:
                        d = pipe.device
                        inp = torch.cat([sched.scale_model_input(x.to(d), i), rows["img_lat"]],
                                        dim=-1)
                        preds.append(pipe.unet(inp, torch.tensor(sched.timesteps[i], device=d),
                                               rows["states"], rows["add_ids"],
                                               context_clips=ctx))
                    uncond, cond = (q.to(dev) for q in preds)
                    x = sched.step(uncond + guidance * (cond - uncond), i, x)
            return x
        table, sigma0 = denoise_table(steps, dev)
        inputs = dict(states=states_cfg, img_lat=img_lat_cfg, add_ids=add_ids,
                      guidance=guidance)
        return self._denoise_loop("denoise", latents, table, sigma0, inputs, trace=trace)
