"""Scalar metrics: JSONL always, TensorBoard when importable (counterpart of
``training/metrics.py``); adds steps/s between logged steps."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=logdir)
        except ImportError:  # tensorboard not installed
            self._tb = None
        self._t_last = time.perf_counter()
        self._step_last: Optional[int] = None

    def log(self, step: int, **scalars: float) -> None:
        now = time.perf_counter()
        if self._step_last is not None and step > self._step_last:
            scalars.setdefault("steps_per_sec", (step - self._step_last) / (now - self._t_last))
        self._t_last, self._step_last = now, step
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
