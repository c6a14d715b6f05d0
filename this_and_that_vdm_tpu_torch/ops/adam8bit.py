"""K4: the 8-bit AdamW moment update of one leaf, hand-written for Hopper
(``csrc/adam8bit.cu``).

Counterpart of ``this_and_that_vdm_tpu/ops/adam8bit_pallas.py`` (the Pallas
``_adam8bit_kernel`` launched by ``_leaf_call``).  One pass over a leaf's
``[NB, 256]`` quantisation blocks: dequantise both uint8 moments through the
closed-form log codebook (``ops/quant8.py``) times the block scales, update
them as EMAs, write the bias-corrected step ``m_hat / (sqrt(v_hat) + eps)``,
requantise both with their new block absmax.  The kernel takes every leaf
on CUDA, the ragged last block included (the caller pads it with zero
gradient and zero codes); the JAX 32-block threshold is a TPU launch rule.
Bound: bytes, 12 a parameter (157 MB at the 13.1 M-parameter GEGLU leaf).

``adam8bit_update`` is the wrapper: on CPU tensors it takes the plain
version (``_plain``, the math of the JAX jnp path,
``training/optimizers.py:169-174``), on CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _native
from .quant8 import BLOCK, DECADES, LOG2_10, decode, encode

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

N_MAGS_M, N_MAGS_V = 127, 255  # signed first moment, unsigned second moment


def _dequant(q, scale, signed: bool, n_mags: int):
    return decode(q.float(), signed, n_mags) * scale[:, None]


def _quant(x, signed: bool, n_mags: int):
    """[NB, 256] fp32 -> (uint8 codes [NB, 256], fp32 block absmax [NB])."""
    scale = x.abs().amax(dim=1)
    safe = torch.where(scale > 0.0, scale, 1.0)
    return encode(x / safe[:, None], signed, n_mags).to(torch.uint8), scale


def _plain(g, mq, ms, nq, ns, bc: Tuple[float, float], b1: float, b2: float, eps: float):
    """The update in plain torch, operation for operation the JAX jnp path.
    ``bc`` divides as a tensor, as in JAX (torch would multiply a CUDA
    tensor by the reciprocal of a Python-float divisor)."""
    bc = torch.as_tensor(bc, dtype=torch.float32, device=g.device)
    m = b1 * _dequant(mq, ms, True, N_MAGS_M) + (1 - b1) * g
    n = b2 * _dequant(nq, ns, False, N_MAGS_V) + (1 - b2) * g * g
    mhat = m / bc[0]
    nhat = n / bc[1]
    step = mhat / (torch.sqrt(nhat) + eps)
    mq2, ms2 = _quant(m, True, N_MAGS_M)
    nq2, ns2 = _quant(n, False, N_MAGS_V)
    return step, mq2, ms2, nq2, ns2


def _codebook_consts(n_mags: int):
    step = DECADES / (n_mags - 1)
    mid = (1.0 + 10.0 ** step) / 2.0
    return step, mid * 10.0 ** (-DECADES), step * LOG2_10


def _hyper(bc, b1: float, b2: float, eps: float):
    """The kernel's 17 fp32 constants (``Adam8Params``), each folded in
    float64 as the plain version's Python floats are, then rounded."""
    lo = 10.0 ** (-DECADES)
    vals = (b1, b2, 1 - b1, 1 - b2, eps, bc[0], bc[1], lo * 1e-6, lo / 2.0, DECADES,
            LOG2_10) + _codebook_consts(N_MAGS_M) + _codebook_consts(N_MAGS_V)
    return (ctypes.c_float * len(vals))(*np.asarray(vals, np.float32).tolist())


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1**t, 1 - b2**t)`` in fp32 from the fp32 count, as the JAX
    update forms ``bc`` (``training/optimizers.py:147-148``)."""
    cf = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** cf), float(one - np.float32(b2) ** cf))


def adam8bit_update(g, mq, ms, nq, ns, bc: Tuple[float, float], b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8):
    """One update of one leaf.  ``g`` [NB, 256] fp32; ``mq``/``nq`` [NB, 256]
    uint8 codes; ``ms``/``ns`` [NB] fp32 block scales; ``bc`` the fp32 bias
    corrections.  Returns (step [NB, 256] fp32, mq', ms', nq', ns')."""
    global launches
    if g.device.type == "cpu":
        return _plain(g, mq, ms, nq, ns, bc, b1, b2, eps)
    if g.device.type != "cuda":
        raise ValueError(f"adam8bit_update: unsupported device {g.device}")
    nb = g.shape[0]
    if g.dim() != 2 or g.shape[1] != BLOCK or nb == 0:
        raise ValueError(f"adam8bit_update: g must be [NB, {BLOCK}], got {tuple(g.shape)}")
    if g.dtype != torch.float32 or mq.dtype != torch.uint8 or nq.dtype != torch.uint8 \
            or ms.dtype != torch.float32 or ns.dtype != torch.float32:
        raise ValueError("adam8bit_update: g, ms, ns fp32; mq, nq uint8")
    if mq.shape != g.shape or nq.shape != g.shape or ms.shape != (nb,) or ns.shape != (nb,):
        raise ValueError("adam8bit_update: mq, nq [NB, 256]; ms, ns [NB]")
    ins = (g, mq, ms, nq, ns)
    if any(t.device != g.device for t in ins):
        raise ValueError("adam8bit_update: tensors on different devices")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("adam8bit_update: tensors must be contiguous")
    if g.data_ptr() % 16 or mq.data_ptr() % 16 or nq.data_ptr() % 16:
        raise ValueError("adam8bit_update: g, mq, nq must be 16-byte aligned")
    step = torch.empty_like(g)
    mq2, nq2 = torch.empty_like(mq), torch.empty_like(nq)
    ms2, ns2 = torch.empty_like(ms), torch.empty_like(ns)
    _native.launch("ttv_adam8bit", g.data_ptr(), mq.data_ptr(), ms.data_ptr(), nq.data_ptr(),
                   ns.data_ptr(), step.data_ptr(), mq2.data_ptr(), ms2.data_ptr(),
                   nq2.data_ptr(), ns2.data_ptr(), nb, _hyper(bc, b1, b2, eps),
                   _native.stream_ptr(g))
    launches += 1
    return step, mq2, ms2, nq2, ns2
