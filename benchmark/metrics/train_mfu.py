"""The train step's share of the card's bf16 peak: the reference's FLOPs of
a step (the UNet's forward and backward, the frozen encodes; the recompute
of checkpointed blocks not counted) over ``train_step_s``, over
989 TFLOP/s whatever the dtype."""

from benchmark import peaks, work


def read(r):
    if not r.get("steps") or not r["window_s"]:
        return None
    step_flops, encode_flops, _ = work.train_step(r["config"])
    return 100.0 * (step_flops + encode_flops) * r["steps"] / r["window_s"] / peaks.BF16_FLOPS
