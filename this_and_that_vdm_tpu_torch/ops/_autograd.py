"""Gradients through the kernels: the JAX ``custom_vjp`` rule in torch.

The JAX package differentiates each Pallas kernel with a ``custom_vjp``
whose backward runs through the reference math (``ops/flash_attention.py``
``_flash_bwd``, ``models/layers.py`` ``_fused_gn_bwd``, ``ops/ln_matmul.py``
``_bwd``); it has no backward kernel.  The port does the same:
each wrapper's ``torch.autograd.Function`` launches the kernel forward and,
in backward, recomputes the plain version on detached copies of the saved
inputs and returns its vector-Jacobian product.

A launch that no gradient will flow through (``torch.no_grad()``, or no
input that requires grad) skips the Function: it saves nothing.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd will record a call on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain, inputs, needs, grad_out):
    """Gradients of ``plain(*inputs)`` against ``grad_out`` for each input
    whose ``needs`` flag is set (``None`` for the others): the plain
    version is recomputed under ``enable_grad`` on detached copies."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
        out = plain(*xs)
        wrt = [x for x, n in zip(xs, needs) if n and x is not None]
        grads = iter(torch.autograd.grad(out, wrt, grad_out) if wrt else ())
    return tuple(next(grads) if n and t is not None else None
                 for t, n in zip(inputs, needs))
