"""The served clips' share of the card's bf16 peak: the reference's FLOPs
of a clip (denoise loop, encodes, decode) times the clips completed in the
window, over the window, over 989 TFLOP/s."""

from benchmark import peaks, work


def read(r):
    if not r.get("completed") or not r["window_s"]:
        return None
    return 100.0 * work.clip_flops(r["config"]) * r["completed"] / r["window_s"] \
        / peaks.BF16_FLOPS
