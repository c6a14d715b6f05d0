"""The three Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode).  Run on a machine with an H100:
``python -m pytest tests/test_torch_kernels.py -q -m cuda``.
Bounds: fp32 1e-4 relative (max abs error over max abs reference); bf16
2e-2 relative (bf16 rounding of the normalised / probability tensor).
"""

import pytest
import torch

from this_and_that_vdm_tpu_torch import ops
from this_and_that_vdm_tpu_torch.ops import flash_attention, groupnorm, ln_matmul

pytestmark = pytest.mark.cuda

BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1536, 5, 64), (2, 384, 10, 64), (1, 1000, 2, 64),
                                   (1, 300, 2, 128)])
def test_flash_attention_kernel(dev, dtype, shape):
    q, k, v = (_randn(shape, dtype, dev, s) for s in range(3))
    ops.reset_launch_counts()
    got = flash_attention.flash_attention(q, k, v, shape[-1] ** -0.5)
    want = flash_attention._plain(q, k, v, shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert _rel(got, want) < BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps,silu", [((4, 1536, 320), 1e-6, True),
                                            ((2, 3, 24, 32, 640), 1e-5, False),
                                            ((1, 4096, 2560), 1e-6, True),
                                            ((2, 1000, 96), 1e-6, False),
                                            ((1, 14 * 32 * 48, 128), 1e-6, True)])
def test_groupnorm_kernel(dev, dtype, shape, eps, silu):
    x = _randn(shape, dtype, dev, 0) * 3 + 1
    c = shape[-1]
    w, b = _randn((c,), torch.float32, dev, 1), _randn((c,), torch.float32, dev, 2)
    ops.reset_launch_counts()
    got = groupnorm.group_norm(x, w, b, 32, eps, silu)
    want = groupnorm._plain(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert groupnorm.launches == 1
    assert _rel(got, want) < BOUND[dtype]


def test_groupnorm_kernel_constant_input_is_finite(dev):
    x = torch.full((2, 512, 320), 7.0, device=dev, dtype=torch.bfloat16)
    w = torch.ones(320, device=dev)
    b = torch.linspace(-1, 1, 320, device=dev)
    got = groupnorm.group_norm(x, w, b, 32, 1e-6, False)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - b).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,n,bias", [(3000, 320, 960, False), (1000, 320, 2560, True),
                                        (384, 1280, 10240, True), (77, 64, 40, True)])
def test_ln_matmul_kernel(dev, dtype, r, c, n, bias):
    x = _randn((r, c), dtype, dev, 0)
    s, b = 1 + 0.1 * _randn((c,), torch.float32, dev, 1), 0.1 * _randn((c,), torch.float32, dev, 2)
    w = _randn((n, c), dtype, dev, 3) / c ** 0.5
    wb = _randn((n,), torch.float32, dev, 4) if bias else None
    ops.reset_launch_counts()
    got = ln_matmul.ln_matmul(x, s, b, w, wb)
    want = ln_matmul._reference(x, s, b, w, wb, 1e-5)
    torch.cuda.synchronize()
    assert ln_matmul.launches == 1
    assert _rel(got, want) < BOUND[dtype]


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 128, 2, 80), device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, 0.1)  # D=80
    with pytest.raises(ValueError):
        groupnorm.group_norm(torch.zeros((1, 8, 100), device=dev), torch.ones(100),
                             torch.zeros(100), 32, 1e-5)  # C % G
    with pytest.raises(ValueError):
        groupnorm.group_norm(torch.zeros((1, 8, 68), device=dev), torch.ones(68),
                             torch.zeros(68), 4, 1e-5)  # C % 8
    with pytest.raises(ValueError):
        ln_matmul.ln_matmul(torch.zeros((16, 4096), device=dev), torch.ones(4096),
                            torch.zeros(4096), torch.zeros((8, 4096), device=dev))  # C > 2048
    with pytest.raises(ValueError):
        x = torch.zeros((16, 64), device=dev, dtype=torch.float16)
        ln_matmul.ln_matmul(x, torch.ones(64), torch.zeros(64), torch.zeros((8, 64)))
