"""The readers of the program's spans (``metrics/server.device_idle_ms.py``,
``pipeline.device_idle_ms.py``, ``pipeline.encode_decode_device_ms.py``,
``denoiser.replay_device_ms.py``) on synthetic summaries and spans: a gap
split between two spans, the window's filter, None without spans; and a
traced tiny run on the CPU whose idle the owners add up to."""

import types

import pytest
import torch

from benchmark import harness, trace
from benchmark.tests.tiny import ROOT, tiny_root

METRICS = ROOT / "benchmark" / "metrics"
WORKER, CLIENT = 1, 2


def reader(name):
    return harness.load_module(METRICS / f"{name}.py")


def span(name, start, end, thread=WORKER, device_ms=None, **attrs):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, thread=thread,
                                 attrs=attrs, device_ms=device_ms)


def summary(t0, t1, device):
    return trace.Summary([("k", s, e) for s, e in device], {}, [], t0, t1)


@pytest.fixture
def spans(monkeypatch):
    from this_and_that_vdm_tpu_torch.utils import profiling

    store = []
    monkeypatch.setattr(profiling, "spans", lambda: list(store))
    return store


def test_idle_split_between_spans_and_owners(spans):
    # worker: wait 0-100, hold 100-110, call 110-400 {prepare 110-130,
    # pipeline.call 130-380 {cond_encode 140-200, denoise.replay 220-360},
    # deliver 380-400}, wait 400-500; a client's queue span is not the worker's
    spans += [span("server.wait", -50, 100), span("server.hold", 100, 110),
              span("server.call", 110, 400, batch=2),
              span("server.prepare", 110, 130), span("pipeline.call", 130, 380),
              span("pipeline.cond_encode", 140, 200, device_ms=5e-5),
              span("denoise.replay", 220, 360, device_ms=1.2e-4, steps=2),
              span("server.deliver", 380, 400), span("server.wait", 400, 600),
              span("server.queue", 90, 110, thread=CLIENT)]
    # device busy 0-95, 125-135 (a gap 95-125 split over wait, hold, call,
    # prepare), 145-195, 230-350, 385-390; idle ends at the window's end
    r = dict(summary=summary(0, 500, [(0, 95), (125, 135), (145, 195), (230, 350),
                                      (385, 390)]))
    parts = reader("server.device_idle_ms").split(r)
    ms = 1e-6 / 2  # ns -> ms, over 2 clips
    assert parts["wait"] == pytest.approx((5 + 100) * ms)          # 95-100, 400-500
    # hold 100-110, prepare 110-125, deliver 380-385 and 390-400
    assert parts["server"] == pytest.approx((10 + 15 + 5 + 10) * ms)
    # pipeline.call 135-140, 200-220, 360-380; cond_encode 140-145, 195-200;
    # denoise.replay 220-230, 350-360
    assert parts["pipeline"] == pytest.approx((5 + 20 + 20 + 5 + 5 + 10 + 10) * ms)
    assert parts["none"] == parts["other"] == 0
    assert sum(parts[k] for k in ("server", "pipeline", "wait")) == pytest.approx(parts["idle"])
    assert reader("server.device_idle_ms").read(r) == parts["server"]
    assert reader("pipeline.device_idle_ms").read(r) == parts["pipeline"]
    assert reader("pipeline.encode_decode_device_ms").read(r) == pytest.approx(5e-5 / 2)
    assert reader("denoiser.replay_device_ms").read(r) == pytest.approx(1.2e-4 / 2)


def test_window_filter(spans):
    # two calls; the window holds the second only: its clips, its stages
    spans += [span("server.call", 0, 100, batch=4),
              span("pipeline.decode", 10, 20, device_ms=7.0),
              span("denoise.replay", 30, 90, device_ms=50.0, steps=25),
              span("server.wait", 100, 200),
              span("server.call", 200, 300, batch=1),
              span("pipeline.decode", 210, 220, device_ms=3.0),
              span("denoise.replay", 230, 290, device_ms=25.0, steps=25),
              span("server.wait", 300, 400)]
    r = dict(summary=summary(150, 400, []))
    assert reader("pipeline.encode_decode_device_ms").read(r) == 3.0
    assert reader("denoiser.replay_device_ms").read(r) == 1.0
    parts = reader("server.device_idle_ms").split(r)
    assert parts["clips"] == 1 and parts["idle"] == pytest.approx(250e-6)
    # the wait 150-200 and 300-400; the call 200-210, 220-230, 290-300
    assert parts["wait"] == pytest.approx(150e-6) and parts["server"] == pytest.approx(30e-6)
    assert parts["pipeline"] == pytest.approx(70e-6)


def test_none_without_spans(spans, monkeypatch):
    names = ("server.device_idle_ms", "pipeline.device_idle_ms",
             "pipeline.encode_decode_device_ms", "denoiser.replay_device_ms")
    assert all(reader(n).read({}) is None for n in names)          # no profile
    r = dict(summary=summary(0, 100, []))
    assert all(reader(n).read(r) is None for n in names)           # no span
    spans += [span("server.call", 10, 50, batch=1), span("pipeline.decode", 20, 30)]
    # a CPU run: no device interval
    assert reader("pipeline.encode_decode_device_ms").read(r) is None
    assert reader("denoiser.replay_device_ms").read(r) is None
    from this_and_that_vdm_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")                         # a program without them
    assert all(reader(n).read(r) is None for n in names)


def test_traced_tiny_run_idle_adds_up(tmp_path):
    """A traced run at the tiny size on the CPU (no device activity: the
    whole window is idle) puts every idle instant down to the server, the
    pipeline or the wait."""
    torch.set_num_threads(4)
    root = tiny_root(tmp_path)
    cell = harness.Cell("vgl-serve-c1", root)
    gen = harness.load_module(cell.generator)
    r = gen.run(cell, 7, 6.0, True, torch.device("cpu"), 0.0)
    parts = reader("server.device_idle_ms").split(r)
    assert parts["clips"] >= 1 and parts["none"] == parts["other"] == 0
    owned = parts["server"] + parts["pipeline"] + parts["wait"]
    assert owned == pytest.approx(parts["idle"], rel=1e-9)
    assert parts["idle"] * parts["clips"] == pytest.approx(r["summary"].window_s * 1e3, rel=1e-6)
    assert parts["pipeline"] > parts["server"]
