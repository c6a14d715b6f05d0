"""Ops of the port: attention dispatch, the three Hopper kernels and resize."""

from . import flash_attention, groupnorm, ln_matmul

# the kernel wrappers, each with its module-level launch counter
KERNELS = {
    "flash_attention": flash_attention,
    "groupnorm": groupnorm,
    "ln_matmul": ln_matmul,
}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}
