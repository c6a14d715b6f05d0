"""K3 (LayerNorm -> projection) in fp32 in the train step: the least time of
its calls at the reference's shapes (fp32 operands at the TF32 tensor-core
peak, 495 TFLOP/s, or 3.35 TB/s) over the device time of the kernels named
below.  The calls are the reference's, counted on the meta device: the UNet
forward's LN -> projection sites and their recompute in the backward of the
checkpointed blocks, once a step."""

from benchmark import peaks, work

KERNELS = ("ln_matmul_f32",)


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("steps_traced"):
        return None
    seconds = summary.device_seconds(lambda n: any(k in n for k in KERNELS))
    if not seconds:
        return None
    bound = sum(peaks.ln_matmul_bound_s(rows, c, n, 4, peaks.TF32_FLOPS)
                for kind, rows, c, n in (x for x in work.train_step(r["config"])[2]
                                         if x[0] == "ln_matmul"))
    return 100.0 * bound * r["steps_traced"] / seconds
