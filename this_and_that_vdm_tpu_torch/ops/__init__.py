"""Ops of the port: attention dispatch, the four Hopper kernels, the 8-bit
quantiser and resize."""

from . import adam8bit, flash_attention, groupnorm, ln_matmul

# the kernel wrappers, each with its module-level launch counter (a wrapper
# adds one where it launches its kernel)
KERNELS = {
    "flash_attention": flash_attention,
    "groupnorm": groupnorm,
    "ln_matmul": ln_matmul,
    "adam8bit": adam8bit,
}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a replayed
    CUDA graph launches the kernels its capture recorded without calling a
    wrapper (``pipelines/svd.py`` ``StepGraph``)."""
    for name, n in counts.items():
        KERNELS[name].launches += n
