"""K3: LayerNorm -> matmul (+ bias), hand-written for Hopper (``csrc/ln_matmul.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/ln_matmul.py`` (the Pallas
``_kernel`` launched by ``_ln_matmul_pallas_local``, held against
``_reference``).  The kernel normalises each row block once in fp32, keeps
it in shared memory in the input dtype and multiplies it by streamed weight
tiles with fp32 accumulation and the bias in the epilogue; the normalised
tensor never reaches device memory.  bf16 runs on wgmma with a TMA ring
(tiles from ``plan``); fp32 runs on mma.sync in 3xTF32 with a cp.async ring
(``plan_f32``), and above C = 320 writes the normalised rows once to a
scratch and streams them.  See the source's header for the designs.  Bound at the qkv
site (R=43008, C=320, N=960): 26 GFLOP against ~110 MB, about even; 70
GFLOP at the level-3 GEGLU input (R=2688, C=1280, N=10240), FLOPs.

``ln_matmul`` is the wrapper used at every LN -> projection site of the
port's transformers: on a CPU tensor it takes the plain version
(``_reference``), on a CUDA tensor it launches the kernel or raises.  Its
gradient (x, scale, bias, w, wb) is the JAX ``custom_vjp`` rule (``_bwd``):
the backward recomputes ``_reference`` and differentiates it (``_autograd``).

``ln_matmul_geglu`` is the same kernel with the GEGLU epilogue, for the
feed-forward's first projection in bf16: w [2I, C] (h's rows, then the
gate's) -> ``h * gelu(gate)`` [.., I], computed from the fp32 accumulators
with exact GELU and one rounding, so the [R, 2I] projection and the GELU and
product passes over it never reach device memory.  Its plain version and
gradient are ``_reference_geglu``: ``_reference``, then the feed-forward's
own ``chunk`` and ``h * gelu(gate)``, each rounding to x's dtype.  bf16
only: fp32 models (the trained GestureNet, VL's trained UNet) keep that
composition with ``ln_matmul``; a bf16 one in a gradient path (VGL
training's frozen UNet) runs the kernel and recomputes the composition in
the backward.

Weights follow ``nn.Linear``: ``w`` is [N, C] (out, in), ``wb`` is [N].
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _autograd, _native

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
geglu_launches = 0  # of which with the GEGLU epilogue

_MAX_C = 2048  # fp32
_MAX_C_BF16 = 1280  # a warp holds a row in registers, 5 pieces of 8 a lane (UNITS)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_MAX_STAGES = 8
_SMS = 132  # streaming multiprocessors of an H100 SXM (the wrapper asks the card)


class Plan(NamedTuple):
    """Tiles of the bf16 kernel: ``wm`` = 2 gives 128-row x 128-column tiles
    (one warpgroup per 64 rows), ``wm`` = 1 gives 64 x 256 (one per 128
    columns); ``stages`` of the weight ring, each [bn, kw] (kw = 64 columns
    at 128-byte swizzle, 32 at 64-byte); ``obn`` output columns a tile
    (``bn``, or ``bn / 2`` under the GEGLU epilogue: each 128 weight rows
    are 64 of h and the same 64 of the gate); ``smem`` bytes; ``tiles``
    (row block, column tile) pairs, ``tiles_n`` per row block, cut into
    ``grid`` contiguous ranges, one per block."""
    wm: int
    bm: int
    bn: int
    obn: int
    kw: int
    stages: int
    smem: int
    tiles_n: int
    tiles: int
    grid: int


def plan(r: int, c: int, n: int, sms: int = _SMS, geglu: bool = False) -> Plan:
    """The largest row block whose normalised rows ([bm, C] bf16, in 64-column
    blocks) fit in shared memory beside at least two weight stages; raises
    ValueError when none does.  Mirrors the kernel's layout (``LnTiles`` and
    ``ln_smem_bytes`` in csrc/ln_matmul.cu): 1024 bytes of alignment slack,
    the rows, the ring, 8 bytes a barrier (two per stage, two for the rows).
    ``n`` is the output's width; under ``geglu`` the weight has 2n rows, and
    the rows and the ring are the same."""
    kb = -(-c // 64)
    for wm in (2, 1) if c <= _MAX_C_BF16 else ():
        bm, bn, kw = 64 * wm, 256 // wm, 32 * wm
        fixed = 1024 + kb * bm * 128 + 16
        stage = bn * kw * 2 + 16
        stages = min(_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
        if stages >= 2:
            obn = bn // 2 if geglu else bn
            tiles_n = -(-n // obn)
            tiles = -(-r // bm) * tiles_n
            return Plan(wm, bm, bn, obn, kw, stages, fixed + stages * stage, tiles_n, tiles,
                        min(tiles, sms))
    raise ValueError(f"ln_matmul: bf16 needs C <= {_MAX_C_BF16} (the normalised rows live "
                     f"in shared memory and a row in one warp's registers), got C={c}")


# fp32 tiles (csrc/ln_matmul.cu F32Cfg): 128 x 128, chunks of 32 columns of
# C in a ring of 3 stages (rows resident) or 4 (rows streamed)
_F32_BM = _F32_BN = 128
_F32_KW = 32
_F32_STAGES = {False: 3, True: 4}


class PlanF32(NamedTuple):
    """Tiles of the fp32 kernel: ``stream`` -- the normalised rows go
    through a device scratch and the ring, else they stay in shared memory
    at a row stride of ``lda`` floats; ``smem`` bytes; ``tiles`` (row block,
    column tile) pairs, ``tiles_n`` per row block, cut into ``grid``
    contiguous ranges, one per block."""
    stream: bool
    lda: int
    smem: int
    tiles_n: int
    tiles: int
    grid: int


def plan_f32(r: int, c: int, n: int, sms: int = _SMS) -> PlanF32:
    """The rows stay in shared memory when 128 of them fit beside the ring
    (C <= 320), else they stream.  Mirrors ``f32_lda`` and ``f32_smem`` in
    csrc/ln_matmul.cu: resident rows at a stride of C rounded up to 32, + 8
    floats (8 mod 32: the 8-byte fragment loads are free of bank
    conflicts), and ring stages of [128 (+ 128 rows when streamed), 32 + 8]."""
    lda = -(-c // 32) * 32 + 8
    for stream in (False, True):
        rows = 0 if stream else _F32_BM * lda
        stage = ((_F32_BM if stream else 0) + _F32_BN) * (_F32_KW + 8)
        smem = 4 * (rows + _F32_STAGES[stream] * stage)
        if smem <= SMEM_LIMIT:
            break
    tiles_n = -(-n // _F32_BN)
    tiles = -(-r // _F32_BM) * tiles_n
    return PlanF32(stream, lda, smem, tiles_n, tiles, min(tiles, sms))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _reference_geglu(x, scale, bias, w, wb, eps: float):
    """``_reference``, then the feed-forward's GEGLU on its two halves (h's
    rows of w first): exact GELU in fp32 rounded to x's dtype, as torch's
    GELU, then the product in x's dtype."""
    h, gate = _reference(x, scale, bias, w, wb, eps).chunk(2, dim=-1)
    return h * F.gelu(gate)


def _launch(x2, scale, bias, w, wb, eps, geglu: bool = False):
    global launches, geglu_launches
    r, c = x2.shape
    n = w.shape[0] // 2 if geglu else w.shape[0]
    out = torch.empty((r, n), device=x2.device, dtype=x2.dtype)
    is_bf16 = x2.dtype == torch.bfloat16
    scratch = None
    if is_bf16:
        p = plan(r, c, n, _sm_count(x2.device.index), geglu)
        tiles = (p.wm, p.stages, p.grid, p.smem)
    else:
        p = plan_f32(r, c, n, _sm_count(x2.device.index))
        tiles = (int(p.stream), 0, p.grid, p.smem)
        if p.stream:  # the normalised rows, written once and streamed
            scratch = torch.empty_like(x2)
    _native.launch("ttv_ln_matmul", x2, x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   w.data_ptr(), 0 if wb is None else wb.data_ptr(), out.data_ptr(),
                   0 if scratch is None else scratch.data_ptr(),
                   r, c, n, float(eps), int(is_bf16), int(geglu), *tiles)
    launches += 1
    geglu_launches += int(geglu)
    return out


class _LnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, w, wb, eps, geglu=False):
        ctx.save_for_backward(x2, scale, bias, w, wb)
        ctx.eps, ctx.plain = eps, (_reference_geglu if geglu else _reference)
        if geglu:
            return _launch(x2, scale, bias, w, wb, eps, geglu=True)
        return _launch(x2, scale, bias, w, wb, eps)

    @staticmethod
    def backward(ctx, grad):
        grads = _autograd.plain_vjp(
            lambda x, s, b, w, wb: ctx.plain(x, s, b, w, wb, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:5], grad)
        return grads + (None, None)


def ln_matmul(x, scale, bias, w, wb: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """``layer_norm_fp32(x, scale, bias) @ w.T (+ wb)``; x: [..., C], w: [N, C]."""
    return _call(x, scale, bias, w, wb, eps, geglu=False)


def ln_matmul_geglu(x, scale, bias, w, wb: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """``h * gelu(gate)`` of ``ln_matmul(x, scale, bias, w, wb)``'s two halves;
    x: [..., C], w: [2I, C] (h's rows, then the gate's) -> [..., I].  On the
    card bf16 only, one launch with the GEGLU epilogue."""
    return _call(x, scale, bias, w, wb, eps, geglu=True)


def _call(x, scale, bias, w, wb, eps, geglu: bool):
    name, width = ("ln_matmul_geglu", "I") if geglu else ("ln_matmul", "N")
    c = x.shape[-1]
    n = w.shape[0] // 2 if geglu else w.shape[0]
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        plain = _reference_geglu if geglu else _reference
        return plain(x.reshape(-1, c), scale, bias, w, wb, eps).reshape(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in ((torch.bfloat16,) if geglu else (torch.float32, torch.bfloat16)):
        raise ValueError(f"{name}: dtype {x.dtype}")
    if c % 8 or c > _MAX_C:
        raise ValueError(f"{name}: needs C % 8 == 0 and C <= {_MAX_C}, got C={c}")
    wn = 2 * n if geglu else n
    if w.shape != (wn, c) or scale.shape != (c,) or bias.shape != (c,) \
            or (wb is not None and wb.shape != (wn,)):
        rows = f"2{width}" if geglu else width
        raise ValueError(f"{name}: w [{rows}, C], scale/bias [C], wb [{rows}]")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    x2 = x.view(-1, c)
    if x.dtype == torch.bfloat16 and (n % 8 or c > _MAX_C_BF16):  # what ``plan`` fits
        raise ValueError(f"{name}: bf16 needs {width} % 8 == 0 and C <= {_MAX_C_BF16}, "
                         f"got C={c} {width}={n}")
    w = w.to(x.dtype).contiguous()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if wb is not None:
        wb = wb.to(device=x.device, dtype=torch.float32).contiguous()
    if any(t.data_ptr() % 16 for t in (x2, w, scale, bias) + (() if wb is None else (wb,))):
        raise ValueError(f"{name}: x, w, scale, bias and wb must be 16-byte aligned")
    if _autograd.needs_grad(x2, scale, bias, w, wb):
        out = _LnMatmul.apply(x2, scale, bias, w, wb, eps, geglu)
    else:
        out = _launch(x2, scale, bias, w, wb, eps, geglu)
    return out.view(*lead, n)
