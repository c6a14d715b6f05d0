"""K4 (the 8-bit AdamW update of every leaf in one launch): its bytes at
3.35 TB/s (12 a parameter, 16 a block, over the reference's UNet leaves)
over the device time of the kernels named below, a step."""

import math

from benchmark import peaks, weights

KERNELS = ("adam8bit_multi",)


def read(r):
    summary = r.get("summary")
    if summary is None or not r.get("steps_traced"):
        return None
    seconds = summary.device_seconds(lambda n: any(k in n for k in KERNELS))
    if not seconds:
        return None
    unet = weights.reference_skeleton("unet", r["config"]["models"]["unet"])
    numels = [math.prod(p.shape) for p in unet.parameters()]
    return 100.0 * peaks.adam8bit_bound_s(numels) * r["steps_traced"] / seconds
