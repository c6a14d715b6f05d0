"""Device milliseconds of one replayed denoise step (ControlNet + UNet):
the profiler's device activity inside the denoise spans over the steps
they ran."""


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("denoise_batches"):
        return None
    seconds = sum(t for _, t in summary.in_span("_denoise_loop"))
    steps = len(r["denoise_batches"]) * r["config"]["sampling"]["num_inference_steps"]
    return 1e3 * seconds / steps if seconds else None
