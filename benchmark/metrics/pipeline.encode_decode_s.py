"""Host seconds a clip spent outside the denoise loop: the benchmark's
synchronised spans around the pipeline's ``encode_conditioning`` (CLIP and
the first frame's VAE encode), ``encode_condition_img`` (the gesture
raster's VAE encode) and ``_finish`` (chunked decode, uint8, copy to the
host), over the clips of the traced run's window calls."""


def read(r):
    stages = r.get("stage_s")
    clips = sum(r.get("denoise_batches") or [])
    if not stages or not clips:
        return None
    total = sum(sum(stages[k]) for k in ("encode_conditioning", "encode_condition_img", "_finish"))
    return total / clips
