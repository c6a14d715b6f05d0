"""Device milliseconds a clip of the pipeline's work outside the denoise
loop: the elapsed time between the timing events of the program's
``pipeline.cond_encode`` (CLIP, the first frame's VAE encode),
``pipeline.gesture_encode`` (the raster's VAE encode), ``pipeline.decode``
(chunked VAE decode) and ``pipeline.to_host`` (uint8, copy to the host)
spans that opened in the traced window, over the clips of its
``server.call`` spans.  The events synchronise nothing."""

from pathlib import Path

STAGES = ("pipeline.cond_encode", "pipeline.gesture_encode", "pipeline.decode",
          "pipeline.to_host")


def read(r):
    from benchmark import harness

    server = harness.load_module(Path(__file__).with_name("server.device_idle_ms.py"))
    got = server.program_spans(r)
    if got is None:
        return None
    spans, summary = got
    clips = sum(c.attrs.get("batch", 0)
                for c in server.opened_inside(spans, summary, "server.call"))
    stages = [s for name in STAGES for s in server.opened_inside(spans, summary, name)]
    if not clips or not stages or any(s.device_ms is None for s in stages):
        return None
    return sum(s.device_ms for s in stages) / clips
