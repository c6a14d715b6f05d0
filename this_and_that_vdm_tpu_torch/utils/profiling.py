"""Tracing and profiling (counterpart of
``this_and_that_vdm_tpu/utils/profiling.py``), in PyTorch's idiom.

* ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA where
  a card is present), written to ``<logdir>/trace.json`` as a Chrome trace,
  with the program's spans of the block (below) as tracks of their own, a
  track a thread, on the same clock.
* ``annotate(name)``: a named region in the trace
  (``torch.profiler.record_function``) while a profiler runs; otherwise a
  no-op that costs one flag read.
* ``span(name, device)``: a span of the program's own (see below).
* ``device_memory_stats(device)``: the card's allocator usage
  (``torch.cuda.memory_stats``); ``{}`` on the CPU.
* ``StepTimer``: rolling steps / second with an optional warmup skip; the
  caller synchronises the device before each ``tick``.

Spans.  A span records its name, start and end on ``time.time_ns()`` (the
clock of the profiler's events, so spans and kernels line up), its thread,
an id, the id of the span open around it on its thread (``parent``), a few
attributes (call id, request ids, batch size, steps) and, where ``device``
is a CUDA device, a device interval: two timing events recorded on the
device's current stream at its ends, from a small pool.  The events are
resolved (``device_ms``, the elapsed milliseconds between them) when the
spans are read, or earlier once they have completed; no span waits on the
device.  Recording is on inside ``recording()`` and while any
``torch.profiler`` profile runs (``profiler_running()``, a process-wide
flag that every thread sees); off, a span site costs a flag read and makes
no event.  The store is a ring of ``MAX_SPANS`` spans (``dropped()`` counts
those pushed out); ``spans()`` returns it, resolved, and ``clear()``
empties it.

A span is stored when recording was on at its open; a span opened with
``start_ns=`` (its start taken by the caller) always takes its times and is
stored when recording was on at its open or at its close, so a timeline
that must have no hole (the server's worker) keeps the span that was open
when a profile started or stopped.  ``trace=`` (a dict): the caller asks
for wall seconds; the span is timed, the device is synchronised at its end,
and its seconds go to ``trace[key]``.

The spans of the served path (what each covers is at the site): the
server's ``server.queue`` (a request, submit to its call, on the submitting
thread), ``server.wait``, ``server.hold``, ``server.call`` and inside it
``server.prepare``, ``pipeline.call`` and ``server.deliver``; the
pipelines' ``pipeline.cond_encode``, ``pipeline.gesture_encode``,
``pipeline.decode``, ``pipeline.to_host`` (with device intervals),
``denoise.replay`` / ``denoise.eager`` (a call's denoise loop, device
interval, ``steps`` and ``batch``) and ``pipeline.capture`` (a step
graph's warm-up call and capture).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 20

_recording = 0                      # depth of recording() blocks
_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_pending: collections.deque = collections.deque()   # spans with unresolved events
_event_pool: dict = {}              # device index -> free timing events
_thread_names: dict = {}
_ids = itertools.count(1)
_local = threading.local()


def profiler_running() -> bool:
    """True while a ``torch.profiler`` profile runs anywhere in the
    process: its start sets a module flag of ``torch.autograd.profiler``
    that every thread reads."""
    return _autograd_profiler._is_profiler_enabled


def active() -> bool:
    """Whether spans opened now are recorded."""
    return _recording > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block (on every thread)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Null:
    """The span site when nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _take_event(dev: torch.device):
    pool = _event_pool.setdefault(dev.index, [])
    try:
        return pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class Span:
    """One span (see the module docstring); a context manager that opens
    it.  ``device_ms`` is None without a device interval, or until
    :func:`spans` resolves it."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "attrs", "device_ms",
                 "_on", "_device", "_events", "_timed", "_trace", "_key")

    def __init__(self, name: str, device=None, trace: Optional[dict] = None,
                 key: Optional[str] = None,
                 start_ns: Optional[int] = None, **attrs):
        self.name, self.attrs = name, attrs
        self.id, self.parent, self.thread = next(_ids), None, None
        self.start_ns, self.end_ns, self.device_ms = start_ns, None, None
        dev = None if device is None else torch.device(device)
        self._device = dev if dev is not None and dev.type == "cuda" else None
        self._timed = trace is not None or start_ns is not None
        self._trace = trace
        self._key = key if key is not None else name.split(".", 1)[-1]
        self._events = None
        self._on = False

    def __enter__(self) -> "Span":
        stack = _open_spans()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        self._on = active()
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        if self._on and self._device is not None:
            dev = self._device
            if dev.index is None:
                dev = self._device = torch.device("cuda", torch.cuda.current_device())
            self._events = (_take_event(dev), _take_event(dev))
            self._events[0].record(torch.cuda.current_stream(dev))
        stack.append(self)
        return self

    def __exit__(self, exc_type, *exc):
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._trace is not None and exc_type is None and self._device is not None:
            torch.cuda.synchronize(self._device)  # the caller asked for wall seconds
        self.end_ns = time.time_ns()
        _open_spans().pop()
        if self._trace is not None and exc_type is None:
            self._trace[self._key] = (self.end_ns - self.start_ns) * 1e-9
        if self._on or (self._timed and active()):
            _store_span(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.start_ns}..{self.end_ns}, {self.attrs}, device_ms={self.device_ms})")


def span(name: str, device=None, *, trace: Optional[dict] = None, key: Optional[str] = None,
         start_ns: Optional[int] = None, **attrs):
    """A span over the ``with`` block; ``device`` (a CUDA device) adds a
    device interval.  Off, and neither ``trace`` nor ``start_ns`` given: a
    no-op, whose ``as`` target is None."""
    if not (_recording or _autograd_profiler._is_profiler_enabled
            or trace is not None or start_ns is not None):
        return _NULL
    return Span(name, device, trace, key, start_ns, **attrs)


def record(name: str, start_ns: int, end_ns: int, *, thread: Optional[int] = None,
           keep: bool = False, **attrs) -> Optional[Span]:
    """Store a span that the caller timed itself (one that crosses threads,
    or a wait): when recording is on, or ``keep``.  ``thread``: the thread
    it belongs to (default: this one); its parent is the span open here."""
    if not (keep or active()):
        return None
    sp = Span(name, start_ns=start_ns, **attrs)
    stack = _open_spans()
    sp.parent = stack[-1].id if stack else None
    sp.thread = threading.get_ident() if thread is None else thread
    sp.end_ns = end_ns
    _store_span(sp)
    return sp


def _store_span(sp: Span):
    global _dropped
    with _lock:
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(sp)
        if sp.thread == threading.get_ident() and sp.thread not in _thread_names:
            _thread_names[sp.thread] = threading.current_thread().name
        if sp._events is not None:
            _pending.append(sp)
            _resolve(wait=False)


def _resolve(wait: bool):
    """Resolve the device intervals of the pending spans, oldest first:
    those whose end event has completed, or all (``wait``, at read time).
    Called under ``_lock``."""
    while _pending:
        sp = _pending[0]
        start, end = sp._events
        if wait:
            end.synchronize()
        elif not end.query():
            return
        sp.device_ms = start.elapsed_time(end)
        pool = _event_pool.setdefault(sp._device.index, [])
        pool += [start, end]
        sp._events = None
        _pending.popleft()


def spans() -> list:
    """The stored spans, oldest first, their device intervals resolved."""
    with _lock:
        _resolve(wait=True)
        return list(_store)


def dropped() -> int:
    """Spans pushed out of the full ring since the last ``clear()``."""
    return _dropped


def clear():
    """Empty the store."""
    global _dropped
    with _lock:
        _store.clear()
        _pending.clear()
        _dropped = 0


def annotate(name: str):
    """Named region visible in the trace viewer while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def _chrome_events(spans_, base_ns: int, pid: int) -> list:
    """``spans_`` as Chrome trace events (``ph`` ``X``, microseconds from
    ``base_ns``), a track (``tid``) a thread, each named ``spans <thread>``."""
    names = {**_thread_names, **{t.ident: t.name for t in threading.enumerate()}}
    tids, out = {}, []
    for sp in spans_:
        if sp.thread not in tids:
            tid = tids[sp.thread] = (1 << 31) + len(tids)
            out.append(dict(ph="M", name="thread_name", pid=pid, tid=tid,
                            args=dict(name=f"spans {names.get(sp.thread, sp.thread)}")))
        args = dict(sp.attrs, id=sp.id, parent=sp.parent)
        if sp.device_ms is not None:
            args["device_ms"] = sp.device_ms
        out.append(dict(ph="X", cat="program_span", name=sp.name, pid=pid, tid=tids[sp.thread],
                        ts=(sp.start_ns - base_ns) / 1e3, dur=(sp.end_ns - sp.start_ns) / 1e3,
                        args=args))
    return out


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=act)
    t0 = time.time_ns()
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        t1 = time.time_ns()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        inside = [sp for sp in spans() if sp.start_ns < t1 and sp.end_ns > t0]
        doc["traceEvents"] += _chrome_events(inside, int(doc.get("baseTimeNanoseconds", 0)),
                                            os.getpid())
        with open(path, "w") as f:
            json.dump(doc, f)


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of a CUDA
    device (default: the current one); ``{}`` for the CPU or without a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


class StepTimer:
    """Rolling steps / second, skipping the first ``warmup`` steps."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._count = 0
        # warmup = 0: the rate over every step, measured from construction
        self._t0: Optional[float] = time.perf_counter() if warmup == 0 else None

    def tick(self) -> Optional[float]:
        """Call once per step, after synchronising the device; returns
        steps / second so far (None during the warmup)."""
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()
            return None
        if self._t0 is None or self._count <= self.warmup:
            return None
        return (self._count - self.warmup) / (time.perf_counter() - self._t0)
