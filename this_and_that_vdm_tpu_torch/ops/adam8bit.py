"""K4: the 8-bit AdamW moment update, hand-written for Hopper
(``csrc/adam8bit.cu``): every leaf of a tree in one launch.

Counterpart of ``this_and_that_vdm_tpu/ops/adam8bit_pallas.py`` (the Pallas
``_adam8bit_kernel`` launched by ``_leaf_call``, once a leaf).  One pass over
each leaf's 256-element quantisation blocks: dequantise both uint8 moments
through the closed-form log codebook (``ops/quant8.py``) times the block
scales, update them as EMAs, write the bias-corrected step
``m_hat / (sqrt(v_hat) + eps)``, requantise both with their new block absmax.
The blocks of all leaves are numbered in one sequence (:func:`leaf_blocks`);
the kernel finds a block's leaf in a table sent once a step, reads the
gradient up to the leaf's numel (the ragged last block needs no padded
copy), writes each leaf's step to its own output (the optimizer passes the
gradient itself), and writes the new moments to four arenas in that
numbering, of which each leaf's are views.  Bound: bytes, 12 a parameter
plus 16 a block.

``adam8bit_leaves`` is the wrapper: on CPU tensors it takes the plain
version, a loop of ``_plain`` (the math of the JAX jnp path,
``training/optimizers.py:169-174``) over the leaves; on CUDA tensors it
launches the kernel once or raises.  ``adam8bit_update`` is its one-leaf
call on ``[NB, 256]`` blocks.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def leaf_blocks(numels: Sequence[int]) -> Tuple[List[int], int]:
    """(first global block of each leaf, total blocks): leaf i owns blocks
    [first[i], first[i] + ceil(numel_i / 256)) of the kernel's numbering."""
    first, total = [], 0
    for n in numels:
        first.append(total)
        total += -(-n // BLOCK)
    return first, total


def leaf_rows(numels: Sequence[int], lo: int, hi: int) -> List[Tuple[int, int, int]]:
    """The part of each leaf in blocks ``[lo, hi)`` of the kernel's
    numbering, as ``(leaf, first element, end element)``, leaves with
    nothing there left out.  A part starts on a block boundary of its leaf,
    so its blocks are blocks of the whole leaf: K4 over the parts (each as a
    leaf of its own, with those blocks' codes and scales) computes those
    rows bit for bit as K4 over the whole leaves does."""
    first, _ = leaf_blocks(numels)
    out = []
    for i, (n, f) in enumerate(zip(numels, first)):
        b0, b1 = max(lo, f), min(hi, f - (-n // BLOCK))
        if b0 < b1:
            out.append((i, (b0 - f) * BLOCK, min(n, (b1 - f) * BLOCK)))
    return out


def leaf_table(gs, mqs, mss, nqs, nss, steps) -> np.ndarray:
    """The kernel's table, one row of 8 int64 a leaf (``Leaf`` in
    ``csrc/adam8bit.cu``): the addresses of g, mq, ms, nq, ns, then numel,
    the first global block, the address of the step's output."""
    numels = [g.numel() for g in gs]
    rows = np.zeros((len(gs), 8), np.int64)
    for j, ts in enumerate((gs, mqs, mss, nqs, nss)):
        rows[:, j] = [t.data_ptr() for t in ts]
    rows[:, 5], rows[:, 6] = numels, leaf_blocks(numels)[0]
    rows[:, 7] = [t.data_ptr() for t in steps]
    return rows


def _plain_leaves(gs, mqs, mss, nqs, nss, bc, b1, b2, eps, out=None):
    """The plain version of the tree update: ``_plain`` on each leaf, its
    gradient padded with zeros to whole blocks and the step cut back (and
    copied into ``out``, where given)."""
    res_lists = ([], [], [], [], [])
    for i, (g, mq, ms, nq, ns) in enumerate(zip(gs, mqs, mss, nqs, nss)):
        nb, gf = ms.shape[0], g.reshape(-1).float()
        g2d = F.pad(gf, (0, nb * BLOCK - gf.numel())).reshape(nb, BLOCK)
        res = _plain(g2d, mq.reshape(nb, BLOCK), ms, nq.reshape(nb, BLOCK), ns, bc, b1, b2, eps)
        step = res[0].reshape(-1)[:gf.numel()]
        res = (step if out is None else out[i].copy_(step), res[1].reshape(-1), res[2],
               res[3].reshape(-1), res[4])
        for lst, t in zip(res_lists, res):
            lst.append(t)
    return res_lists


def _launch_leaves(gs, mqs, mss, nqs, nss, bc, b1, b2, eps, out):
    global launches
    dev = gs[0].device
    numels = [g.numel() for g in gs]
    total = leaf_blocks(numels)[1]
    steps = [torch.empty_like(g) for g in gs] if out is None else out
    for g, mq, ms, nq, ns, st, n in zip(gs, mqs, mss, nqs, nss, steps, numels):
        nb = -(-n // BLOCK)
        if g.dtype != torch.float32 or ms.dtype != torch.float32 or ns.dtype != torch.float32 \
                or st.dtype != torch.float32 or mq.dtype != torch.uint8 or nq.dtype != torch.uint8:
            raise ValueError("adam8bit: g, ms, ns and the step fp32; mq, nq uint8")
        if st.numel() != n:
            raise ValueError(f"adam8bit: a step output of {st.numel()} for a leaf of {n}")
        if mq.numel() != nb * BLOCK or nq.numel() != nb * BLOCK or ms.numel() != nb \
                or ns.numel() != nb:
            raise ValueError(f"adam8bit: a leaf of {n} elements needs {nb} blocks of codes "
                             f"and scales, got {mq.numel()}, {nq.numel()}, {ms.numel()}, "
                             f"{ns.numel()}")
        if any(t.device != dev or not t.is_contiguous() for t in (g, mq, ms, nq, ns, st)):
            raise ValueError("adam8bit: every tensor contiguous, on one device")
        if n and (g.data_ptr() % 16 or mq.data_ptr() % 16 or nq.data_ptr() % 16
                  or st.data_ptr() % 16):
            raise ValueError("adam8bit: g, mq, nq and the step must be 16-byte aligned")
    table = torch.empty((len(gs), 8), dtype=torch.int64, pin_memory=True)
    table.numpy()[:] = leaf_table(gs, mqs, mss, nqs, nss, steps)
    table = table.to(dev, non_blocking=True)
    mq2 = torch.empty((total * BLOCK,), device=dev, dtype=torch.uint8)
    nq2 = torch.empty((total * BLOCK,), device=dev, dtype=torch.uint8)
    ms2 = torch.empty((total,), device=dev, dtype=torch.float32)
    ns2 = torch.empty((total,), device=dev, dtype=torch.float32)
    _native.launch("ttv_adam8bit_multi", mq2, table.data_ptr(), len(gs), total, mq2.data_ptr(),
                   ms2.data_ptr(), nq2.data_ptr(), ns2.data_ptr(), _hyper(bc, b1, b2, eps),
                   -(-total // 8))
    launches += 1
    # per-leaf views of the new moments
    nbs = [-(-n // BLOCK) for n in numels]
    codes = [nb * BLOCK for nb in nbs]
    return (steps, list(mq2.split(codes)), list(ms2.split(nbs)), list(nq2.split(codes)),
            list(ns2.split(nbs)))


def adam8bit_leaves(gs, mqs, mss, nqs, nss, bc: Tuple[float, float], b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8, out=None):
    """One update of every leaf of a tree.  Per leaf: ``g`` fp32 gradient of
    any shape (``numel`` elements); ``mq``/``nq`` uint8 codes and ``ms``/``ns``
    fp32 block scales of ``nb = ceil(numel / 256)`` blocks (codes flat
    ``[nb * 256]`` or ``[nb, 256]``, the ragged tail holding the zero codes);
    ``bc`` the fp32 bias corrections; ``out``: where each step goes (fp32,
    ``numel`` elements, the gradient itself allowed), new tensors when None.
    Returns five lists, leaf by leaf: the step, mq' ``[nb * 256]``, ms'
    ``[nb]``, nq', ns'."""
    if not gs:
        return [], [], [], [], []
    if gs[0].device.type == "cpu":
        return _plain_leaves(gs, mqs, mss, nqs, nss, bc, b1, b2, eps, out)
    if gs[0].device.type != "cuda":
        raise ValueError(f"adam8bit_leaves: unsupported device {gs[0].device}")
    # empty leaves (a leaf outside a rank's rows) take no part in the launch
    keep = [i for i, g in enumerate(gs) if g.numel()]
    res = tuple([None] * len(gs) for _ in range(5))
    for i in set(range(len(gs))) - set(keep):
        for lst, t in zip(res, (gs[i] if out is None else out[i], mqs[i], mss[i], nqs[i],
                                nss[i])):
            lst[i] = t.reshape(-1).clone()
    if keep:
        pick = lambda ts: [ts[i] for i in keep]  # noqa: E731
        got = _launch_leaves(pick(gs), pick(mqs), pick(mss), pick(nqs), pick(nss), bc, b1,
                             b2, eps, None if out is None else pick(out))
        for lst, ts in zip(res, got):
            for i, t in zip(keep, ts):
                lst[i] = t
    return res


def adam8bit_rows(gs, mqs, mss, nqs, nss, bc: Tuple[float, float], rows: Tuple[int, int],
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One update of blocks ``[lo, hi) = rows`` of a tree of whole leaves
    (the arguments of :func:`adam8bit_leaves`): the leaves are cut to their
    parts in those rows (:func:`leaf_rows`) and updated in one call.
    Returns ``(parts, five lists)``: ``parts`` the ``(leaf, first, end)`` of
    each piece, then the step, mq', ms', nq', ns' of each."""
    parts = leaf_rows([g.numel() for g in gs], *rows)
    cut = ([], [], [], [], [])
    for i, e0, e1 in parts:
        blocks = slice(e0 // BLOCK, -(-e1 // BLOCK))
        codes = slice(blocks.start * BLOCK, blocks.stop * BLOCK)
        for lst, t in zip(cut, (gs[i].reshape(-1)[e0:e1], mqs[i].reshape(-1)[codes],
                                mss[i][blocks], nqs[i].reshape(-1)[codes], nss[i][blocks])):
            lst.append(t)
    return parts, adam8bit_leaves(*cut, bc, b1, b2, eps)


def adam8bit_update(g, mq, ms, nq, ns, bc: Tuple[float, float], b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8):
    """One update of one leaf: the one-leaf call of :func:`adam8bit_leaves`.
    ``g`` [NB, 256] fp32; ``mq``/``nq`` [NB, 256] uint8 codes; ``ms``/``ns``
    [NB] fp32 block scales; ``bc`` the fp32 bias corrections.  Returns (step
    [NB, 256] fp32, mq', ms', nq', ns')."""
    if g.device.type == "cpu":
        return _plain(g, mq, ms, nq, ns, bc, b1, b2, eps)
    if g.device.type != "cuda":
        raise ValueError(f"adam8bit_update: unsupported device {g.device}")
    nb = g.shape[0]
    if g.dim() != 2 or g.shape[1] != BLOCK or nb == 0:
        raise ValueError(f"adam8bit_update: g must be [NB, {BLOCK}], got {tuple(g.shape)}")
    if mq.shape != g.shape or nq.shape != g.shape or ms.shape != (nb,) or ns.shape != (nb,):
        raise ValueError("adam8bit_update: mq, nq [NB, 256]; ms, ns [NB]")
    step, mq2, ms2, nq2, ns2 = (out[0] for out in _launch_leaves(
        [g], [mq], [ms], [nq], [ns], bc, b1, b2, eps, None))
    return step.view(nb, BLOCK), mq2.view(nb, BLOCK), ms2, nq2.view(nb, BLOCK), ns2
