"""The traced run: torch.profiler over a stretch of the window, kept in
memory and reduced to a summary (no trace file is written).

The summary holds the device's activity (kernels, copies, sets) as
``(name, start_ns, end_ns)``, the spans that the benchmark opened with
``span()`` (each synchronised at both ends, so every kernel that its work
launched runs inside it), and the host's operations and CUDA calls, for
naming the gaps in which the device was idle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str, device, sink: dict):
    """A span synchronised at both ends, recorded in ``sink[name]`` as
    ``(start_ns, end_ns)`` on ``time.time_ns()``, the profiler's clock: it
    works in any thread, where the profiler follows only the one that
    started it."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.time_ns()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    sink.setdefault(name, []).append((t0, time.time_ns()))


class Profile:
    """``start()`` / ``stop()`` around the traced stretch; ``summary()``
    after the stop."""

    def __init__(self):
        act = torch.profiler.ProfilerActivity
        # the device's activity and the CUDA calls that launched it; recording
        # every host operation as well would slow a host-bound step
        acts = [act.CUDA] if torch.cuda.is_available() else [act.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self):
        self.prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)

    def summary(self, spans=None) -> "Summary":
        """``spans``: the benchmark's spans (see :func:`span`)."""
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((name, start, start + dur))
            else:
                host.append((start, start + dur, name))
        spans = dict(spans or {})
        host += [(s, e, SPAN_PREFIX + name) for name, ivs in spans.items() for s, e in ivs]
        return Summary(device, spans, host, self.t0, self.t1)


class Summary:
    def __init__(self, device, spans, host, t0, t1):
        self.device = sorted(device, key=lambda d: d[1])
        self.spans, self.t0, self.t1 = spans, t0, t1
        self.host = sorted(host)
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _union(self):
        out = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        return sum(e - s for s, e in self._union()) * 1e-9

    def in_span(self, span_name: str, match=None):
        """Device activity inside the spans ``span_name``: ``(name, seconds)``,
        names filtered by ``match`` (a predicate) when given."""
        out = []
        for s0, s1 in self.spans.get(span_name, []):
            lo = bisect.bisect_left(self.device, s0 - 10 ** 6, key=lambda d: d[1])
            for name, s, e in self.device[lo:]:
                if s > s1:
                    break
                if s0 <= (s + e) // 2 <= s1 and (match is None or match(name)):
                    out.append((name, (e - s) * 1e-9))
        return out

    def device_seconds(self, match) -> float:
        """Seconds of device activity whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-9

    def top_ops(self, n: int = 10):
        acc = defaultdict(int)
        for name, s, e in self.device:
            acc[name[:120]] += e - s
        return [[k, v * 1e-9] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest stretches of the window with no device activity,
        each named by the innermost host span or CUDA call open at its start
        (``host``: none was)."""
        edges = [self.t0] + [x for iv in self._union() for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            i = bisect.bisect_right(self._host_starts, s) - 1
            name = "host"
            for hs, he, hn in reversed(self.host[max(0, i - 5000):i + 1]):
                if he >= s:
                    name = hn
                    break
            out.append([name[:120], (e - s) * 1e-9])
        return out
