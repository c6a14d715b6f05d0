"""XMem video-object segmentation (counterpart of ``models/xmem.py``), fp32.

The curation path's click-to-mask tracker: a ResNet50 key encoder with a
key projection (key, shrinkage, selection), a ResNet18 value encoder fused
with the key features through CBAM and a GRU hidden state, the space-time
memory readout (selection-weighted L2 similarity, top-k softmax), and a
multi-scale decoder with a GRU hidden updater.

Modules carry the state-dict names of the published ``XMem-s012.pth``
(``key_encoder.res2.0.conv1.weight``, ``value_encoder.fuser.attention.
ChannelGate.mlp.1.weight``, ...), so the file loads with
``load_state_dict(strict=True)`` and no key mapping.  Batch norms are
``FrozenBatchNorm2d`` (eval-mode affine over the running statistics).

Layout: convolutions run NCHW (frames ``[B, 3, H, W]``, object groups
``[B, N, C, h, w]`` folded into the batch); memory attention is
token-major (keys ``[B, N, CK]``, queries ``[B, P, CK]``) with the tokens
of a ``[C, h, w]`` map in row-major ``h * w`` order, as in the JAX module,
so memory slots line up between the two.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .frozen_bn import FrozenBatchNorm2d

# ImageNet normalisation of frames before XMem (reference
# tracker/util/range_transform.py)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(frames_01: torch.Tensor) -> torch.Tensor:
    """``[..., H, W, 3]`` in [0, 1] -> ImageNet-normalised."""
    mean = frames_01.new_tensor(IMAGENET_MEAN)
    std = frames_01.new_tensor(IMAGENET_STD)
    return (frames_01 - mean) / std


# --------------------------------------------------------------- ResNet trunks


class BasicBlock(nn.Module):
    """ResNet18 block (tracker/model/resnet.py:46-75)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False),
                                            FrozenBatchNorm2d(planes))

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + r)


class Bottleneck(nn.Module):
    """ResNet50 block, expansion 4 (tracker/model/resnet.py:78-114)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            FrozenBatchNorm2d(cout))

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + r)


def _layer(block, cin: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    out = planes * (4 if block is Bottleneck else 1)
    rest = [block(out, planes) for _ in range(blocks - 1)]
    return nn.Sequential(block(cin, planes, stride), *rest)


class KeyEncoder(nn.Module):
    """ResNet50 through layer3 -> (f16: 1024, f8: 512, f4: 256); its layer1
    is named ``res2`` in the checkpoint (tracker/model/modules.py:153-175)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.res2 = _layer(Bottleneck, 64, 64, 3, 1)
        self.layer2 = _layer(Bottleneck, 256, 128, 4, 2)
        self.layer3 = _layer(Bottleneck, 512, 256, 6, 2)

    def forward(self, frame):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(frame))), 3, 2, 1)
        f4 = self.res2(x)
        f8 = self.layer2(f4)
        return self.layer3(f8), f8, f4


# ------------------------------------------------ fusion, attention, GRU blocks


class _Gate(nn.Module):
    """A bare container, so CBAM's parameters keep their published names."""


class CBAM(nn.Module):
    """Channel attention (shared MLP over avg- and max-pooled descriptors),
    then spatial attention (7x7 conv over [max; mean] across channels)
    (tracker/model/cbam.py).  Keys: ``ChannelGate.mlp.{1,3}``,
    ``SpatialGate.spatial.conv``."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.ChannelGate = _Gate()
        self.ChannelGate.mlp = nn.Sequential(nn.Identity(), nn.Linear(c, c // reduction),
                                             nn.ReLU(), nn.Linear(c // reduction, c))
        self.SpatialGate = _Gate()
        self.SpatialGate.spatial = _Gate()
        self.SpatialGate.spatial.conv = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        mlp = self.ChannelGate.mlp
        att = mlp(x.mean((2, 3))) + mlp(x.amax((2, 3)))
        x = x * torch.sigmoid(att)[:, :, None, None]
        pooled = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.SpatialGate.spatial.conv(pooled))


class GroupResBlock(nn.Module):
    """relu-conv-relu-conv residual; a 3x3 conv shortcut when the width
    changes (tracker/model/group_modules.py:36-55).  Folded ``[B*N, C, H, W]``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.downsample = nn.Conv2d(cin, cout, 3, padding=1) if cin != cout else None

    def forward(self, g):
        y = self.conv2(F.relu(self.conv1(F.relu(g))))
        if self.downsample is not None:
            g = self.downsample(g)
        return y + g


class FeatureFusionBlock(nn.Module):
    """Image features distributed over the object groups and fused through
    CBAM (tracker/model/modules.py:22-41).  x ``[B, Cx, h, w]``, g
    ``[B, N, Cg, h, w]`` -> ``[B, N, out, h, w]``."""

    def __init__(self, x_dim: int, g_dim: int, mid: int, out: int):
        super().__init__()
        self.block1 = GroupResBlock(x_dim + g_dim, mid)
        self.attention = CBAM(mid)
        self.block2 = GroupResBlock(mid, out)

    def forward(self, x, g):
        b, n = g.shape[:2]
        g = torch.cat([x[:, None].expand(-1, n, -1, -1, -1), g], 2).flatten(0, 1)
        g = self.block1(g)
        g = self.block2(g + self.attention(g))
        return g.view(b, n, *g.shape[1:])


def _gru_update(values, h, hidden_dim: int):
    """XMem's GRU: the new value before the forget gate
    (tracker/model/modules.py:64-73).  Channel axis 2."""
    forget = torch.sigmoid(values[:, :, :hidden_dim])
    update = torch.sigmoid(values[:, :, hidden_dim:hidden_dim * 2])
    new_value = torch.tanh(values[:, :, hidden_dim * 2:])
    return forget * h * (1.0 - update) + update * new_value


class HiddenReinforcer(nn.Module):
    """The value encoder's GRU (tracker/model/modules.py:77-99)."""

    def __init__(self, g_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.transform = nn.Conv2d(g_dim + hidden_dim, hidden_dim * 3, 3, padding=1)

    def forward(self, g, h):
        b, n = g.shape[:2]
        v = self.transform(torch.cat([g, h], 2).flatten(0, 1))
        return _gru_update(v.view(b, n, *v.shape[1:]), h, self.hidden_dim)


class HiddenUpdater(nn.Module):
    """The decoder's multi-scale GRU (tracker/model/modules.py:44-74): g8
    and g4 area-downsampled to stride 16."""

    def __init__(self, g_dims, mid: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.g16_conv = nn.Conv2d(g_dims[0], mid, 1)
        self.g8_conv = nn.Conv2d(g_dims[1], mid, 1)
        self.g4_conv = nn.Conv2d(g_dims[2], mid, 1)
        self.transform = nn.Conv2d(mid + hidden_dim, hidden_dim * 3, 3, padding=1)

    def forward(self, g16, g8, g4, h):
        b, n = g16.shape[:2]
        g = (self.g16_conv(g16.flatten(0, 1))
             + self.g8_conv(F.avg_pool2d(g8.flatten(0, 1), 2))
             + self.g4_conv(F.avg_pool2d(g4.flatten(0, 1), 4)))
        v = self.transform(torch.cat([g, h.flatten(0, 1)], 1))
        return _gru_update(v.view(b, n, *v.shape[1:]), h, self.hidden_dim)


class ValueEncoder(nn.Module):
    """ResNet18 over [image; mask; other masks], fused with the key
    features (tracker/model/modules.py:102-150)."""

    def __init__(self, value_dim: int = 512, hidden_dim: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(5, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.layer1 = _layer(BasicBlock, 64, 64, 2, 1)
        self.layer2 = _layer(BasicBlock, 64, 128, 2, 2)
        self.layer3 = _layer(BasicBlock, 128, 256, 2, 2)
        self.fuser = FeatureFusionBlock(1024, 256, value_dim, value_dim)
        self.hidden_reinforce = HiddenReinforcer(value_dim, hidden_dim)

    def forward(self, image, f16, h, masks, others, is_deep_update: bool = True):
        b, n = masks.shape[:2]
        g = torch.stack([masks, others], 2)
        g = torch.cat([image[:, None].expand(-1, n, -1, -1, -1), g], 2).flatten(0, 1)
        g = F.relu(F.max_pool2d(self.bn1(self.conv1(g)), 3, 2, 1))
        g = self.layer3(self.layer2(self.layer1(g)))
        g = self.fuser(f16, g.view(b, n, *g.shape[1:]))
        if is_deep_update:
            h = self.hidden_reinforce(g, h)
        return g, h


class KeyProjection(nn.Module):
    """f16 -> key, shrinkage d^2 + 1, selection sigmoid(e)
    (tracker/model/modules.py:194-211)."""

    def __init__(self, in_dim: int = 1024, key_dim: int = 64):
        super().__init__()
        self.key_proj = nn.Conv2d(in_dim, key_dim, 3, padding=1)
        self.d_proj = nn.Conv2d(in_dim, 1, 3, padding=1)
        self.e_proj = nn.Conv2d(in_dim, key_dim, 3, padding=1)

    def forward(self, x, need_s: bool = True, need_e: bool = True):
        shrinkage = self.d_proj(x) ** 2 + 1.0 if need_s else None
        selection = torch.sigmoid(self.e_proj(x)) if need_e else None
        return self.key_proj(x), shrinkage, selection


def _bilinear_up(x, factor: int):
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


class UpsampleBlock(nn.Module):
    """Skip conv + 2x bilinear-upsampled groups + GroupResBlock
    (tracker/model/modules.py:178-191)."""

    def __init__(self, skip_dim: int, up_dim: int, out_dim: int):
        super().__init__()
        self.skip_conv = nn.Conv2d(skip_dim, up_dim, 3, padding=1)
        self.out_conv = GroupResBlock(up_dim, out_dim)

    def forward(self, skip_f, up_g):
        b, n = up_g.shape[:2]
        skip = self.skip_conv(skip_f)
        g = _bilinear_up(up_g.flatten(0, 1), 2)
        g = self.out_conv(skip[:, None].expand(-1, n, -1, -1, -1).flatten(0, 1) + g)
        return g.view(b, n, *g.shape[1:])


class Decoder(nn.Module):
    """Memory readout + hidden -> logits at full resolution
    (tracker/model/modules.py:214-250)."""

    def __init__(self, value_dim: int = 512, hidden_dim: int = 64):
        super().__init__()
        self.fuser = FeatureFusionBlock(1024, value_dim + hidden_dim, 512, 512)
        self.hidden_update = HiddenUpdater([512, 256, 256 + 1], 256, hidden_dim)
        self.up_16_8 = UpsampleBlock(512, 512, 256)
        self.up_8_4 = UpsampleBlock(256, 256, 256)
        self.pred = nn.Conv2d(256, 1, 3, padding=1)

    def forward(self, f16, f8, f4, hidden, readout, h_out: bool = True):
        b, n = readout.shape[:2]
        g16 = self.fuser(f16, torch.cat([readout, hidden], 2))
        g8 = self.up_16_8(f8, g16)
        g4 = self.up_8_4(f4, g8)
        logits = self.pred(F.relu(g4.flatten(0, 1)))
        if h_out:
            g4c = torch.cat([g4, logits.view(b, n, 1, *logits.shape[-2:])], 2)
            hidden = self.hidden_update(g16, g8, g4c, hidden)
        else:
            hidden = None
        logits = _bilinear_up(logits, 4)
        return hidden, logits.view(b, n, *logits.shape[-2:])


def aggregate(prob: torch.Tensor, dim: int, return_logits: bool = False):
    """STM soft aggregation with an implicit background channel
    (tracker/model/aggregate.py)."""
    bg = torch.prod(1.0 - prob, dim=dim, keepdim=True)
    new_prob = torch.cat([bg, prob], dim).clamp(1e-7, 1 - 1e-7)
    logits = torch.log(new_prob / (1.0 - new_prob))
    prob = F.softmax(logits, dim=dim)
    return (logits, prob) if return_logits else prob


# ------------------------------------------------------ memory attention math


def key_similarity(mk: torch.Tensor, ms: Optional[torch.Tensor], qk: torch.Tensor,
                   qe: Optional[torch.Tensor]) -> torch.Tensor:
    """Negative (selection-weighted) squared L2 similarity, as
    ``-a^2 + 2ab - b^2`` in fp32 (the form of the reference and the JAX
    module; ``cdist`` rounds otherwise and moves the top-k set).

    mk ``[B, N, CK]``, ms ``[B, N]`` or None, qk / qe ``[B, P, CK]`` (qe may be
    None) -> ``[B, P, N]`` over sqrt(CK)."""
    ck = mk.shape[-1]
    if qe is not None:
        a_sq = torch.bmm(qe, mk.square().transpose(1, 2))
        two_ab = 2.0 * torch.bmm(qk * qe, mk.transpose(1, 2))
        b_sq = (qe * qk.square()).sum(-1, keepdim=True)
        sim = -a_sq + two_ab - b_sq
    else:
        a_sq = mk.square().sum(-1)[:, None, :]
        sim = -a_sq + 2.0 * torch.bmm(qk, mk.transpose(1, 2))
    if ms is not None:
        sim = sim * ms[:, None, :]
    return sim / math.sqrt(ck)


def topk_softmax(sim: torch.Tensor, top_k: Optional[int] = None, return_usage: bool = False):
    """Softmax over the memory axis (last), keeping the top-k entries
    (tracker/model/memory_util.py:41-65): ``topk``, softmax of the kept
    values, scattered back into zeros.  ``return_usage`` adds the affinity
    summed over the queries ``[B, N]``."""
    if top_k is not None and top_k < sim.shape[-1]:
        vals, idx = torch.topk(sim, top_k, dim=-1)
        affinity = torch.zeros_like(sim).scatter_(-1, idx, F.softmax(vals, dim=-1))
    else:
        affinity = F.softmax(sim, dim=-1)
    if return_usage:
        return affinity, affinity.sum(1)
    return affinity


def memory_readout(affinity: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """``[B, P, N] x [B, N, CV] -> [B, P, CV]``."""
    return torch.bmm(affinity, mv)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """``[..., C, h, w]`` -> ``[..., h*w, C]`` (row-major token order)."""
    return x.flatten(-2).transpose(-1, -2)


class XMem(nn.Module):
    """XMem (tracker/model/network.py:17-132): ``encode_key``,
    ``encode_value``, ``read_memory`` and ``segment``."""

    def __init__(self, key_dim: int = 64, value_dim: int = 512, hidden_dim: int = 64):
        super().__init__()
        self.key_dim, self.value_dim, self.hidden_dim = key_dim, value_dim, hidden_dim
        self.key_encoder = KeyEncoder()
        self.key_proj = KeyProjection(1024, key_dim)
        self.value_encoder = ValueEncoder(value_dim, hidden_dim)
        self.decoder = Decoder(value_dim, hidden_dim)

    def encode_key(self, frame, need_sk: bool = True, need_ek: bool = True):
        """frame ``[B, 3, H, W]`` -> key, shrinkage, selection at stride 16,
        then f16, f8, f4."""
        f16, f8, f4 = self.key_encoder(frame)
        key, shrinkage, selection = self.key_proj(f16, need_sk, need_ek)
        return key, shrinkage, selection, f16, f8, f4

    def encode_value(self, frame, f16, h16, masks, is_deep_update: bool = True):
        """masks ``[B, N, H, W]`` -> value ``[B, N, CV, h, w]``, hidden.  The
        "others" channel sums every other object's mask (network.py:72-85)."""
        if masks.shape[1] == 1:
            others = torch.zeros_like(masks)
        else:
            others = masks.sum(1, keepdim=True) - masks
        return self.value_encoder(frame, f16, h16, masks, others, is_deep_update)

    def read_memory(self, query_key, query_selection, memory_key, memory_shrinkage,
                    memory_value, top_k: Optional[int] = None):
        """Single-group readout: query_key ``[B, P, CK]``, memory_key
        ``[B, N, CK]``, memory_value ``[B, num_obj, N, CV]`` ->
        ``[B, num_obj, P, CV]``."""
        affinity = topk_softmax(key_similarity(memory_key, memory_shrinkage, query_key,
                                               query_selection), top_k)
        return torch.einsum("bpn,bonc->bopc", affinity, memory_value)

    def segment(self, f16, f8, f4, readout, hidden, h_out: bool = True, strip_bg: bool = True,
                selector=None):
        """readout ``[B, N, CV, h, w]`` -> (hidden, logits ``[B, N+1, H, W]``,
        prob).  ``selector`` ``[B, N]`` masks dead objects' probabilities before
        the aggregation (network.py:112-113)."""
        hidden, logits = self.decoder(f16, f8, f4, hidden, readout, h_out)
        prob = torch.sigmoid(logits)
        if selector is not None:
            prob = prob * selector.reshape(*selector.shape[:2], 1, 1)
        logits, prob = aggregate(prob, 1, return_logits=True)
        if strip_bg:
            prob = prob[:, 1:]
        return hidden, logits, prob
