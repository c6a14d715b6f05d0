"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit) and the least time a kernel's work could take on it."""

BF16_FLOPS = 989e12  # tensor cores, bf16 inputs, fp32 accumulation
TF32_FLOPS = 495e12  # tensor cores, fp32 inputs at TF32
HBM_BYTES = 3.35e12  # bytes/s

GIB = 2.0 ** 30


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The larger of the operations over the peak and the bytes over HBM."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)


def ln_matmul_bound_s(rows: int, c: int, n: int, itemsize: int, peak_flops: float) -> float:
    """LayerNorm then ``[rows, c] @ [c, n]`` (+ bias): the input, the weight
    and the output once each in the input's type, LayerNorm and bias
    parameters in fp32."""
    flops = 2.0 * rows * c * n
    nbytes = itemsize * (rows * c + n * c + rows * n) + 4.0 * (2 * c + n)
    return bound_s(flops, nbytes, peak_flops)


def groupnorm_bound_s(numel: int, itemsize: int) -> float:
    """GroupNorm (+ SiLU): one read and one write of the tensor."""
    return 2.0 * numel * itemsize / HBM_BYTES


def adam8bit_bound_s(numels) -> float:
    """The 8-bit AdamW update of a tree: the fp32 gradient read and the
    step written (8 bytes), both uint8 moments read and written (4 bytes)
    a parameter; both fp32 block scales read and written (16 bytes) a
    256-element block of each leaf."""
    params = sum(numels)
    blocks = sum(-(-n // 256) for n in numels)
    return (12.0 * params + 16.0 * blocks) / HBM_BYTES
