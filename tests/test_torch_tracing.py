"""The port's span recorder (``utils/profiling.py``) and the spans of the
served path (``serving/server.py``, ``pipelines/``), on the CPU:

- off, a span site records nothing and makes no CUDA event;
- ``recording()`` and a running ``torch.profiler`` each switch recording
  on, seen from another thread (the profiler's flag is pinned, so a PyTorch
  that drops it fails here);
- a tiny ``VideoGenServer`` call: parent and request ids, the worker's
  timeline covered by spans with no hole, ``future.timing`` read off them;
- a span brackets the profiler's own timestamps of a region inside it;
- ``trace=`` filled from the same spans; ``trace(logdir)`` exports them;
- the ring's bound, and device intervals resolved without waiting.
"""

import collections
import json
import threading

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu_torch.cli.tokenizer import hash_tokenizer
from this_and_that_vdm_tpu_torch.serving import VideoGenServer
from this_and_that_vdm_tpu_torch.utils import profiling
from this_and_that_vdm_tpu_torch.weights import loader

from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

FR, H, W = 2, 64, 128
SAMPLING = dict(num_frames=FR, num_inference_steps=1, noise_aug_strength=0.1,
                decode_chunk_size=FR)


@pytest.fixture(scope="module")
def pipe():
    return loader.make_pipeline(loader.random_models("tiny", "cpu", seed=3), "vgl")


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _req(i):
    rng = np.random.RandomState(i)
    image = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    cond = rng.uniform(0, 1, (FR, H, W, 3)).astype(np.float32)
    ids = hash_tokenizer()(["pick up", "push the cup left"][i % 2])[0]
    return image, cond, ids


class FakeEvent:
    """A timing event whose completion the test decides."""
    made = clock = 0
    done = True

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def query(self):
        return FakeEvent.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made, FakeEvent.done = 0, True
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(profiling, "_event_pool", {})
    return FakeEvent


# ------------------------------------------------------------- the switch

def test_off_records_nothing_and_makes_no_event(pipe, fake_cuda):
    assert not profiling.active()
    site = profiling.span("pipeline.decode", torch.device("cuda", 0))
    with site as sp:
        pass
    assert sp is None and fake_cuda.made == 0
    with VideoGenServer(pipe, **SAMPLING) as server:
        img, cond, ids = _req(0)
        server.submit(img, condition=cond, prompt_ids=ids, seed=1).result(timeout=600)
    assert profiling.spans() == [] and fake_cuda.made == 0
    # on, the same site makes its two events
    with profiling.recording(), profiling.span("pipeline.decode", torch.device("cuda", 0)):
        pass
    assert fake_cuda.made == 2 and profiling.spans()[0].device_ms is not None


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_switches_are_seen_from_another_thread(switch):
    # the process-wide flag that torch.profiler sets; recording under a
    # running profile reads it
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    seen = []

    def worker():
        seen.append(profiling.active())
        with profiling.span("other.thread"):
            pass

    ctx = (profiling.recording() if switch == "recording"
           else torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]))
    with ctx:
        assert profiling.profiler_running() == (switch == "profiler")
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen == [True] and not profiling.active()
    assert [s.name for s in profiling.spans()] == ["other.thread"]
    assert profiling.spans()[0].thread == t.ident


# ------------------------------------------------------- the served path

def _serve_two(pipe, **kw):
    """Two requests in one call under ``recording()``, opened after the
    server (so its first wait started with recording off) and closed after
    it (its last wait ended with recording on)."""
    server = VideoGenServer(pipe, max_batch=2, max_delay_s=5.0, **SAMPLING)
    with profiling.recording():
        futs = [server.submit(*_req(i)[:2], prompt_ids=_req(i)[2], seed=i, **kw)
                for i in range(2)]
        for f in futs:
            f.result(timeout=600)
        server.close(timeout=600)
    return server, futs, profiling.spans()


def test_served_call_ids_timeline_and_timing(pipe):
    server, futs, spans = _serve_two(pipe)
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    (call,) = by["server.call"]
    assert call.attrs["batch"] == 2 and len(call.attrs["requests"]) == 2
    # a request's queue span, on the submitting thread, names its call
    queues = by["server.queue"]
    assert sorted(q.attrs["request"] for q in queues) == sorted(call.attrs["requests"])
    assert all(q.attrs["call"] == call.attrs["call"] for q in queues)
    assert all(q.thread == threading.get_ident() and q.end_ns == call.start_ns for q in queues)
    # future.timing: the queue span's stretch (on the monotonic clock) and
    # the call's batch
    for f, q in zip(futs, sorted(queues, key=lambda q: q.attrs["request"])):
        assert sorted(f.timing) == ["batch", "queue_s"] and f.timing["batch"] == 2
        assert 0 <= f.timing["queue_s"] == pytest.approx(q.seconds, abs=2e-3)
    # nesting: the call's children, the pipeline's stages inside pipeline.call
    (pcall,) = by["pipeline.call"]
    for name in ("server.prepare", "pipeline.call", "server.deliver"):
        assert [s.parent for s in by[name]] == [call.id]
    for name in ("pipeline.cond_encode", "pipeline.gesture_encode", "denoise.eager",
                 "pipeline.decode", "pipeline.to_host"):
        assert [s.parent for s in by[name]] == [pcall.id], name
    assert by["denoise.eager"][0].attrs == dict(steps=1, batch=2)
    assert all(s.device_ms is None for s in spans)  # no device interval on the CPU
    # the worker's timeline: top-level spans end to end, from the wait that
    # was open when recording started to the one that close() ended
    worker = [s for s in spans if s.thread == server._worker.ident]
    top = sorted((s for s in worker if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in top] == ["server.wait", "server.hold", "server.call", "server.wait"]
    assert all(a.end_ns == b.start_ns for a, b in zip(top, top[1:]))
    assert top[0].start_ns < queues[0].start_ns and top[-1].end_ns > call.end_ns
    # every child lies inside its parent
    ids = {s.id: s for s in worker}
    for s in worker:
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)


def test_trace_dict_filled_from_the_same_spans(pipe):
    trace = {}
    with profiling.recording():
        pipe(_req(0)[0][None], _req(0)[1], prompt_ids=_req(0)[2][None], trace=trace,
             **SAMPLING)
    stored = {s.name: s.seconds for s in profiling.spans()}
    keys = dict(cond_encode="pipeline.cond_encode", gesture_encode="pipeline.gesture_encode",
                denoise="denoise.eager", decode="pipeline.decode", uint8_host="pipeline.to_host")
    assert {k: trace[k] for k in keys} == {k: stored[n] for k, n in keys.items()}
    assert torch.isfinite(trace["latents"]).all()
    # off, the caller's trace is still filled, and nothing is stored
    profiling.clear()
    trace = {}
    pipe(_req(0)[0][None], _req(0)[1], prompt_ids=_req(0)[2][None], trace=trace, **SAMPLING)
    assert set(keys) | {"latents"} == set(trace) and profiling.spans() == []


# ------------------------------------------------------- clock and export

def test_span_brackets_the_profilers_region(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.annotate("inner"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    (outer,) = profiling.spans()
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert inner
    for e in inner:
        assert outer.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= outer.end_ns


def test_trace_export_has_span_tracks(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("server.call", call=7):
            with profiling.annotate("unet.up_blocks.0"):
                torch.randn(16, 16).sum()
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    (ev,) = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert ev["name"] == "server.call" and ev["args"]["call"] == 7
    region = [e for e in doc["traceEvents"] if e.get("name") == "unet.up_blocks.0"
              and e.get("cat") != "program_span"]
    assert region and all(ev["ts"] <= r["ts"] <= ev["ts"] + ev["dur"] for r in region)
    names = [e for e in doc["traceEvents"] if e.get("ph") == "M" and e["tid"] == ev["tid"]]
    assert names[0]["args"]["name"].startswith("spans ")


# ---------------------------------------------------------- store, events

def test_ring_bound(monkeypatch):
    monkeypatch.setattr(profiling, "_store", collections.deque(maxlen=3))
    with profiling.recording():
        for i in range(5):
            with profiling.span("s", i=i):
                pass
    assert [s.attrs["i"] for s in profiling.spans()] == [2, 3, 4] and profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_device_intervals_resolve_without_waiting(fake_cuda):
    dev = torch.device("cuda", 0)
    with profiling.recording():
        fake_cuda.done = False
        with profiling.span("a", dev):
            pass
        assert profiling._pending and profiling._store[0].device_ms is None
        fake_cuda.done = True
        with profiling.span("b", dev):  # a store resolves what has completed
            pass
    assert not profiling._pending
    assert [s.device_ms for s in profiling.spans()] == [1.0, 1.0]
    # the events went back to the pool and were reused
    with profiling.recording(), profiling.span("c", dev):
        pass
    assert fake_cuda.made == 4
