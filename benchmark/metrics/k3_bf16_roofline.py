"""K3 (LayerNorm -> projection, bf16) in the denoise step: the least time of
the step's LN -> projection calls at the reference's shapes (bf16 operands,
989 TFLOP/s or 3.35 TB/s) over the device time of the kernels named below
inside the denoise spans."""

from benchmark import work

KERNELS = ("ln_matmul_bf16",)


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("denoise_batches"):
        return None
    seconds = sum(t for _, t in summary.in_span(
        "_denoise_loop", lambda n: any(k in n for k in KERNELS)))
    if not seconds:
        return None
    steps = r["config"]["sampling"]["num_inference_steps"]
    bound = sum(steps * work.step_bound_s(r["config"], b, "ln_matmul")
                for b in r["denoise_batches"])
    return 100.0 * bound / seconds
