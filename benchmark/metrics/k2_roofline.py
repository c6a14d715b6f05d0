"""K2 (GroupNorm + SiLU, bf16) in the denoise step: one read and one write
of each of the step's GroupNorm inputs at 3.35 TB/s over the device time of
the kernels named below inside the denoise spans."""

from benchmark import work

KERNELS = ("gn_coop",)


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("denoise_batches"):
        return None
    seconds = sum(t for _, t in summary.in_span(
        "_denoise_loop", lambda n: any(k in n for k in KERNELS)))
    if not seconds:
        return None
    steps = r["config"]["sampling"]["num_inference_steps"]
    bound = sum(steps * work.step_bound_s(r["config"], b, "groupnorm")
                for b in r["denoise_batches"])
    return 100.0 * bound / seconds
