"""Tracing and profiling (counterpart of
``this_and_that_vdm_tpu/utils/profiling.py``), in PyTorch's idiom.

* ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA where
  a card is present), written to ``<logdir>/trace.json`` as a Chrome trace.
* ``annotate(name)``: a named region in the trace
  (``torch.profiler.record_function``).
* ``device_memory_stats(device)``: the card's allocator usage
  (``torch.cuda.memory_stats``); ``{}`` on the CPU.
* ``StepTimer``: rolling steps / second with an optional warmup skip; the
  caller synchronises the device before each ``tick``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    act = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=act)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region visible in the trace viewer."""
    return torch.profiler.record_function(name)


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
