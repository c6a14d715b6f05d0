"""K3: LayerNorm -> matmul (+ bias), hand-written for Hopper (``csrc/ln_matmul.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/ln_matmul.py`` (the Pallas
``_kernel`` launched by ``_ln_matmul_pallas_local``, held against
``_reference``).  The kernel normalises each row block in fp32, rounds it to
the input dtype in shared memory and multiplies it by streamed weight tiles
with fp32 accumulation and the bias in the epilogue; the normalised tensor
never reaches device memory.  See the source's header for the design.
Bound: FLOPs — 26 GFLOP against ~110 MB at the qkv site (R=43008, C=320,
N=960), 70 GFLOP at the level-3 GEGLU input (R=2688, C=1280, N=10240).

``ln_matmul`` is the wrapper used at every LN -> projection site of the
port's transformers: on a CPU tensor it takes the plain version
(``_reference``), on a CUDA tensor it launches the kernel or raises.  Its
gradient (x, scale, bias, w, wb) is the JAX ``custom_vjp`` rule (``_bwd``):
the backward recomputes ``_reference`` and differentiates it (``_autograd``).

Weights follow ``nn.Linear``: ``w`` is [N, C] (out, in), ``wb`` is [N].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _autograd, _native

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_MAX_C = 2048


def layer_norm_fp32(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics (two passes, as
    jnp.mean / jnp.var), cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def _reference(x, scale, bias, w, wb, eps: float):
    """The normalised rows in x's dtype, then the product in x's dtype
    (``ops/ln_matmul.py:182-194``)."""
    out = F.linear(layer_norm_fp32(x, scale, bias, eps), w.to(x.dtype))
    if wb is not None:
        out = out + wb.to(x.dtype)
    return out


def _launch(x2, scale, bias, w, wb, eps):
    global launches
    r, c = x2.shape
    n = w.shape[0]
    out = torch.empty((r, n), device=x2.device, dtype=x2.dtype)
    stats = torch.empty((r, 2), device=x2.device, dtype=torch.float32)  # (mean, rstd)
    _native.launch("ttv_ln_matmul", x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   w.data_ptr(), 0 if wb is None else wb.data_ptr(), out.data_ptr(),
                   stats.data_ptr(), r, c, n, float(eps), int(wb is not None),
                   int(x2.dtype == torch.bfloat16), _native.stream_ptr(x2))
    launches += 1
    return out


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, w, wb, eps):
        ctx.save_for_backward(x2, scale, bias, w, wb)
        ctx.eps = eps
        return _launch(x2, scale, bias, w, wb, eps)

    @staticmethod
    def backward(ctx, grad):
        grads = _autograd.plain_vjp(
            lambda x, s, b, w, wb: _reference(x, s, b, w, wb, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:5], grad)
        return grads + (None,)


def ln_matmul(x, scale, bias, w, wb: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """``layer_norm_fp32(x, scale, bias) @ w.T (+ wb)``; x: [..., C], w: [N, C]."""
    c = x.shape[-1]
    n = w.shape[0]
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        return _reference(x.reshape(-1, c), scale, bias, w, wb, eps).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ln_matmul: dtype {x.dtype}")
    if c % 8 or c > _MAX_C:
        raise ValueError(f"ln_matmul: needs C % 8 == 0 and C <= {_MAX_C}, got C={c}")
    if w.shape != (n, c) or scale.shape != (c,) or bias.shape != (c,) \
            or (wb is not None and wb.shape != (n,)):
        raise ValueError("ln_matmul: w [N, C], scale/bias [C], wb [N]")
    if not x.is_contiguous():
        raise ValueError("ln_matmul: x must be contiguous")
    x2 = x.view(-1, c)
    w = w.to(x.dtype).contiguous()
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("ln_matmul: x and w must be 16-byte aligned")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if wb is not None:
        wb = wb.to(device=x.device, dtype=torch.float32).contiguous()
    if _autograd.needs_grad(x2, scale, bias, w, wb):
        out = _LnMatmul.apply(x2, scale, bias, w, wb, eps)
    else:
        out = _launch(x2, scale, bias, w, wb, eps)
    return out.view(*lead, n)
