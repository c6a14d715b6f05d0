"""In-process micro-batching server for clip generation (counterpart of
``this_and_that_vdm_tpu/serving/server.py``).

A resident (usually baked: ``bake_params``, its denoise step a replayed
CUDA graph) pipeline serves concurrent requests:

* requests are **micro-batched**: grouped by everything that changes the
  pipeline call (shapes, steps, frames, guidance, ...) and stacked up to
  ``max_batch`` along the clip axis, so one pipeline invocation serves them;
* per-request **gesture conditions** batch too (``[B, F, H, W, 3]``);
* per-request determinism: each request's noise comes from its own
  ``torch.Generator(device=pipe.device).manual_seed(seed)``, image noise
  ``[1, H, W, 3]`` first, then latents ``[1, F, H/8, W/8, 4]``, the order of
  the pipeline's own draws; so a request served alone equals
  ``pipe(image[None], cond, generator=Generator.manual_seed(seed))`` bit for
  bit, and a batched one equals it up to float noise (the pipelines map
  temporal context per clip);
* callers get ``concurrent.futures.Future`` objects: submit from any thread.
  A result's future carries ``timing``: the request's queue wait, from its
  submit to its batch's close on ``time.perf_counter`` (the stretch of its
  ``server.queue`` span, which is on the wall clock), and the size of the
  batch that served it (its ``server.call`` span's);
* the worker's time is always inside one span of ``utils.profiling``
  (recorded while a profiler runs or inside ``profiling.recording()``), each
  starting where the last ended: ``server.wait`` (blocked on an empty
  queue), ``server.hold`` (the first request in hand, waiting up to
  ``max_delay_s`` for followers), ``server.call`` (one batch: ``call``,
  ``requests``, ``batch``), and inside it ``server.prepare`` (generators,
  draws, stacking, inputs to the device), the pipeline's ``pipeline.call``
  and ``server.deliver`` (results to the host arrays, futures set);
  ``server.queue`` covers a request from its submit to its call, on the
  submitting thread, with its ``request`` and ``call`` ids;
* on a serving mesh (``mesh=parallel.make_serving_mesh(devices, cfg=2)``)
  the pipeline is placed on it once: a batch's clips split over ``clip``,
  each clip's CFG branches over ``cfg``.

Usage::

    server = VideoGenServer(pipe, output_type="uint8")  # or mesh=...
    fut = server.submit(image, condition=raster, prompt_ids=ids, seed=7)
    frames = fut.result()          # [F, H, W, 3]
    server.close()
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling

__all__ = ["VideoGenServer"]

_request_ids = itertools.count(1)
_call_ids = itertools.count(1)


@dataclasses.dataclass
class _Request:
    image: np.ndarray                     # [H, W, 3] in [-1, 1]
    condition: Optional[np.ndarray]       # [F, H, W, 3] in [0, 1] (VGL) | None
    prompt_ids: Optional[np.ndarray]      # [77] int | None
    seed: int
    sampling: Dict[str, Any]
    future: Future
    id: int = dataclasses.field(default_factory=lambda: next(_request_ids))
    t_submit_ns: int = dataclasses.field(default_factory=time.time_ns)  # the span's clock
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)  # queue_s's
    thread: int = dataclasses.field(default_factory=threading.get_ident)


class VideoGenServer:
    """Resident micro-batching front end over a (usually baked) pipeline.

    ``pipe``: a ``StableVideoDiffusionPipeline`` or
    ``StableVideoDiffusionControlNetPipeline``; the server runs on its
    device.  ``mesh``: an optional serving mesh the pipeline is placed on
    at construction.  ``max_batch``: clips per invocation; default (None)
    the mesh's ``clip`` extent, 1 without a mesh.  ``max_delay_s``: how long
    the batcher waits for same-bucket followers once a request is in hand.
    ``default_sampling``: pipeline keyword arguments of every request, which
    ``submit`` may override.
    """

    def __init__(self, pipe, mesh=None, max_batch: Optional[int] = None,
                 max_delay_s: float = 0.05, **default_sampling):
        self.pipe = pipe.place_on_mesh(mesh) if mesh is not None else pipe
        if max_batch is None:
            max_batch = mesh.shape.get("clip", 1) if mesh is not None else 1
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.default_sampling = default_sampling
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._state_lock = threading.Lock()  # submit/close check-then-act
        self._t_free = self._t_closed = time.time_ns()  # the worker's timeline
        self._worker = threading.Thread(target=self._run, daemon=True, name="VideoGenServer")
        self._worker.start()

    # ------------------------------------------------------------------ api
    def submit(self, image: np.ndarray, condition: Optional[np.ndarray] = None,
               prompt_ids: Optional[np.ndarray] = None, seed: int = 0,
               **sampling) -> Future:
        """Enqueue one clip request; returns a Future of [F, H, W, 3]."""
        merged = dict(self.default_sampling)
        merged.update(sampling)
        req = _Request(np.asarray(image), None if condition is None else np.asarray(condition),
                       None if prompt_ids is None else np.asarray(prompt_ids),
                       int(seed), merged, Future())
        with self._state_lock:  # no request may slip in behind the sentinel
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(req)
        return req.future

    def close(self, timeout: Optional[float] = 60.0):
        """Drain outstanding requests and stop the worker."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- batch
    @staticmethod
    def _bucket(req: _Request) -> Tuple:
        """Requests sharing a bucket stack into one pipeline call: identical
        shapes and sampling parameters."""
        return (
            req.image.shape,
            None if req.condition is None else req.condition.shape,
            None if req.prompt_ids is None else req.prompt_ids.shape,
            tuple(sorted(req.sampling.items())),
        )

    def _take_batch(self):
        """Block for one request, then collect same-bucket followers for up
        to ``max_delay_s`` (or until ``max_batch``).  The wait starts where
        the worker's last span ended (``_t_free``); the batch closes at
        ``_t_closed``."""
        on = profiling.active()  # kept if recording is on at either end
        req = self._queue.get()
        t_got = self._t_closed = time.time_ns()
        profiling.record("server.wait", self._t_free, t_got, keep=on)
        if req is None:
            # shutdown sentinel, but a mixed-bucket request re-queued by an
            # earlier round may sit BEHIND it: serve leftovers before exiting
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return None
            if req is None:  # close() enqueues exactly one sentinel
                return None
            self._queue.put(None)  # keep the sentinel behind the leftovers
        bucket = self._bucket(req)
        batch = [req]
        deadline = time.monotonic() + self.max_delay_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the shutdown signal
                break
            if self._bucket(nxt) == bucket:
                batch.append(nxt)
            else:
                self._queue.put(nxt)  # different call: next batch
                break
        self._t_closed, self._t_closed_pc = time.time_ns(), time.perf_counter()
        profiling.record("server.hold", t_got, self._t_closed)
        return batch

    def _run(self):
        dev = self.pipe.device
        if dev.type == "cuda":  # the worker launches on the pipeline's card
            torch.cuda.set_device(dev)
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._execute(batch)
            except Exception as e:  # noqa: BLE001 - propagated to every caller of the batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _execute(self, batch):
        call = profiling.span("server.call", start_ns=self._t_closed, call=next(_call_ids))
        try:
            with call:
                self._call(batch, call, self._t_closed_pc)
        finally:
            self._t_free = call.end_ns

    def _call(self, batch, call, t_start: float):
        # claim the futures: a request whose caller cancelled while queued is
        # dropped here; afterwards cancel() can no longer race set_result
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        cid = call.attrs["call"]
        call.attrs.update(requests=[r.id for r in batch], batch=len(batch))
        if not batch:
            return
        for r in batch:
            profiling.record("server.queue", r.t_submit_ns, call.start_ns, thread=r.thread,
                             request=r.id, call=cid)
        with profiling.span("server.prepare", call=cid):
            sampling = dict(batch[0].sampling)
            num_frames = int(sampling.get("num_frames", 14))
            h, w = batch[0].image.shape[:2]
            dev = self.pipe.device
            image_noise, latents = [], []
            for r in batch:  # each request's own draws, in the pipeline's order
                g = torch.Generator(device=dev).manual_seed(r.seed)
                image_noise.append(torch.randn((1, h, w, 3), generator=g, device=dev))
                latents.append(torch.randn((1, num_frames, h // 8, w // 8, 4), generator=g,
                                           device=dev))
            kwargs = dict(sampling, latents=torch.cat(latents),
                          image_noise=torch.cat(image_noise))
            if batch[0].prompt_ids is not None:
                kwargs["prompt_ids"] = torch.as_tensor(
                    np.stack([r.prompt_ids for r in batch]), device=dev)
            args = [torch.as_tensor(np.stack([r.image for r in batch]), device=dev)]
            if batch[0].condition is not None:
                args.append(torch.as_tensor(np.stack([r.condition for r in batch]), device=dev))
        out = self.pipe(*args, **kwargs)
        with profiling.span("server.deliver", call=cid):
            out = np.asarray(out)
            for i, r in enumerate(batch):
                r.future.timing = dict(queue_s=t_start - r.t_submit, batch=call.attrs["batch"])
                r.future.set_result(out[i])
