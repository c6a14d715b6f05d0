"""Ops of the port: attention dispatch, the four Hopper kernels, the 8-bit
quantiser and resize."""

from . import adam8bit, flash_attention, groupnorm, ln_matmul

# the kernel wrappers' launch counters: name -> (module, attribute); a
# wrapper adds one where it launches its kernel (a launch of K3 with the
# GEGLU epilogue counts under both of K3's names)
KERNELS = {
    "flash_attention": (flash_attention, "launches"),
    "groupnorm": (groupnorm, "launches"),
    "ln_matmul": (ln_matmul, "launches"),
    "ln_matmul_geglu": (ln_matmul, "geglu_launches"),
    "adam8bit": (adam8bit, "launches"),
}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the counters: a replayed
    CUDA graph launches the kernels its capture recorded without calling a
    wrapper (``pipelines/svd.py`` ``StepGraph``)."""
    for name, n in counts.items():
        mod, attr = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + n)
