"""Models of the port (HF/diffusers parameter names, channels-last I/O)."""

from .layers import cast_compute_dtype, init_weights

__all__ = ["cast_compute_dtype", "init_weights"]
