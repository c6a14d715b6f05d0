"""Eval-mode BatchNorm of the perception models (counterpart of
``FrozenBatchNorm`` in ``models/xmem.py``): an affine over the stored
running statistics, whatever the module's train flag.  It holds the five
entries of ``nn.BatchNorm2d``'s state dict (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so published
checkpoints load under their own names."""

from __future__ import annotations

import torch
import torch.nn as nn


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):  # [B, C, H, W]
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]
