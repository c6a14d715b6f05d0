"""PyTorch / CUDA port of this_and_that_vdm_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference.  This package imports torch and
never jax; the three Pallas kernels on the VGL path are hand-written CUDA
kernels under ``csrc/`` (see ``ops/``), built with nvcc at first use.
"""

# the clip the pipelines and trainers default to (the JAX package's values)
FRAME_COUNT_DEFAULT = 14
HEIGHT_DEFAULT = 256
WIDTH_DEFAULT = 384
