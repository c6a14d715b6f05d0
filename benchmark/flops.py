"""Operations and kernel calls of the reference at a cell's shapes, counted
on the meta device (no memory, no device time): the numerators of the
MFU and roofline metrics, so that they read the same work whatever
implements it."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import weights
from .reference import ops as ref_ops


def _count(fn):
    """(FLOPs, recorded kernel-site calls) of ``fn()`` on the meta device."""
    with ref_ops.record() as calls, FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops()), list(calls)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def denoise_step(sizes: dict, rows: int, frames: int, h: int, w: int, controlnet: bool):
    """One CFG-folded step at ``rows`` = 2 x clips: the ControlNet (if any)
    and the UNet."""
    unet = weights.reference_skeleton("unet", sizes["unet"])
    cn = weights.reference_skeleton("gesturenet", sizes["gesturenet"]) if controlnet else None
    ctx = sizes["unet"]["cross_attention_dim"]
    x, t = _meta(rows, frames, h, w, 8), _meta()
    states, ids = _meta(rows, 78, ctx), _meta(rows, 3)

    def run():
        with torch.no_grad():
            res = mid = None
            if cn is not None:
                res, mid = cn(x, t, states, ids, _meta(rows, frames, h, w, 4))
            unet(x, t, states, ids, res, mid)

    return _count(run)


def clip_edges(sizes: dict, clips: int, frames: int, hh: int, ww: int, chunk: int,
               gesture: bool):
    """The work of a call outside the denoise loop: the CLIP towers, the VAE
    encodes (first frame; the gesture raster's frames) and the chunked
    decode."""
    vae = weights.reference_skeleton("vae", sizes["vae"])
    vis = weights.reference_skeleton("image_encoder", sizes["image_encoder"])
    txt = weights.reference_skeleton("text_encoder", sizes["text_encoder"])
    size = sizes["image_encoder"]["image_size"]

    def run():
        with torch.no_grad():
            vis(_meta(clips, size, size, 3))
            txt(torch.zeros((clips, 77), dtype=torch.long, device="meta"))
            vae.encode_mode(_meta(clips, hh, ww, 3))
            if gesture:
                vae.encode_mode(_meta(clips * frames, hh, ww, 3))
            for i in range(0, frames, chunk):
                vae.decode(_meta(clips, min(chunk, frames - i), hh // 8, ww // 8, 4))

    return _count(run)


def vl_train_step(sizes: dict, frames: int, hh: int, ww: int, remat: bool):
    """(FLOPs of the UNet's forward and backward at batch 1, FLOPs of the
    frozen encodes, the kernel-site calls of the forward and of the
    backward's recompute of checkpointed blocks when ``remat``).  The FLOPs
    leave the recompute out."""
    ctx = sizes["unet"]["cross_attention_dim"]
    x = _meta(1, frames, hh // 8, ww // 8, 8)

    def fwd_bwd(unet):  # the backward runs autograd's formulas: the calls are the forward's
        unet.requires_grad_(True)
        return lambda: unet(x, _meta(1), _meta(1, 78, ctx), _meta(1, 3)).sum().backward()

    step_flops, _ = _count(fwd_bwd(weights.reference_skeleton("unet", sizes["unet"])))
    _, calls = _count(fwd_bwd(weights.reference_skeleton("unet", sizes["unet"], remat)))
    edge_flops, _ = clip_edges(sizes, 1, frames, hh, ww, frames, gesture=False)
    vae = weights.reference_skeleton("vae", sizes["vae"])
    dec_flops, _ = _count(lambda: vae.decode(_meta(1, frames, hh // 8, ww // 8, 4)))
    enc_flops, _ = _count(lambda: vae.encode_mode(_meta(frames, hh, ww, 3)))
    # the train step encodes every frame and the first frame again, and decodes nothing
    return step_flops, edge_flops - dec_flops + enc_flops, calls
