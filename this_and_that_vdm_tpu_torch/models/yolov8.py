"""YOLOv8 detector (counterpart of ``models/yolov8.py``), fp32, eval only.

The curation auto-labeler finds the robot gripper with an ultralytics
YOLOv8 model (SURVEY §2.2).  The modules here carry the ultralytics
``DetectionModel`` state-dict names (``model.{i}.conv.weight``,
``model.{i}.bn.running_var``, ``model.22.dfl.conv.weight``, ...), so a
checkpoint read by ``weights/convert.load_ultralytics_state_dict`` loads
with ``load_state_dict(strict=True)`` and no key map.  Convolutions run
NCHW (cuDNN's layout); the model takes ``[B, H, W, 3]`` in [0, 1] and
returns ``[B, N, 4 + nc]``: xywh boxes in input pixels and class
probabilities.  Letterboxing and NMS are host numpy, as in ultralytics; the
letterbox resize needs no cv2 (``data/image.resize_linear``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .frozen_bn import FrozenBatchNorm2d


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclass(frozen=True)
class YOLOv8Config:
    """Scale hyperparameters (ultralytics yolov8.yaml ``scales`` table)."""

    nc: int = 1  # the gripper detector is single-class
    depth: float = 0.33
    width: float = 0.25
    max_channels: int = 1024
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)

    def ch(self, base: int) -> int:
        return _make_divisible(min(base, self.max_channels) * self.width)

    def n(self, base: int) -> int:
        return max(round(base * self.depth), 1)

    @classmethod
    def n_scale(cls, nc: int = 1) -> "YOLOv8Config":
        return cls(nc=nc)

    @classmethod
    def s_scale(cls, nc: int = 1) -> "YOLOv8Config":
        return cls(nc=nc, width=0.50)

    @classmethod
    def m_scale(cls, nc: int = 1) -> "YOLOv8Config":
        return cls(nc=nc, depth=0.67, width=0.75, max_channels=768)

    @classmethod
    def tiny(cls, nc: int = 1) -> "YOLOv8Config":
        """Test-size: half-width n with a 4-bin DFL."""
        return cls(nc=nc, width=0.125, reg_max=4)

    @classmethod
    def from_state_dict(cls, sd) -> "YOLOv8Config":
        """Infer (nc, depth, width, max_channels, reg_max) from an
        ultralytics state dict."""
        w0 = np.shape(sd["model.0.conv.weight"])[0]
        width = w0 / 64.0
        n2 = len({k.split(".")[3] for k in sd if k.startswith("model.2.m.")})
        depth = n2 / 3.0
        nc = np.shape(sd["model.22.cv3.0.2.weight"])[0]
        reg_max = np.shape(sd["model.22.cv2.0.2.weight"])[0] // 4
        c5 = np.shape(sd["model.9.cv2.conv.weight"])[0]
        for mc in (1024, 768, 512):
            if _make_divisible(min(1024, mc) * width) == c5:
                max_channels = mc
                break
        else:
            max_channels = 1024
        return cls(nc=int(nc), depth=depth, width=width, max_channels=max_channels,
                   reg_max=int(reg_max))


class Conv(nn.Module):
    """ultralytics ``Conv``: Conv2d (no bias) + BN (eps 1e-3) + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = FrozenBatchNorm2d(c2, eps=1e-3)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial with 2 splits + n bottlenecks, all concatenated."""

    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, shortcut) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 maxpools."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2, 1)
        self.cv2 = Conv(c1 // 2 * 4, c2, 1)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.cv2(torch.cat(y, 1))


class DFL(nn.Module):
    """Distribution focal loss decode: the expectation of a softmax over
    ``reg_max`` bins under the fixed ``arange`` weight the checkpoint holds."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))

    def forward(self, d):  # [B, N, 4, reg_max] -> [B, N, 4]
        return (d.softmax(-1) * self.conv.weight.reshape(-1)).sum(-1)


class Detect(nn.Module):
    """Decoupled head + DFL decode (ultralytics ``Detect`` inference path)."""

    def __init__(self, cfg: YOLOv8Config, ch: Tuple[int, ...]):
        super().__init__()
        self.cfg = cfg
        c2 = max(16, ch[0] // 4, cfg.reg_max * 4)
        c3 = max(ch[0], min(cfg.nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * cfg.reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, cfg.nc, 1)) for x in ch)
        self.dfl = DFL(cfg.reg_max)

    def forward(self, feats):
        cfg = self.cfg
        boxes, scores = [], []
        for i, (f, stride) in enumerate(zip(feats, cfg.strides)):
            b, _, h, w = f.shape
            box = self.cv2[i](f).permute(0, 2, 3, 1).reshape(b, h * w, 4, cfg.reg_max)
            cls = self.cv3[i](f).permute(0, 2, 3, 1).reshape(b, h * w, cfg.nc)
            # anchor cell centres in feature units (make_anchors, offset 0.5)
            ys, xs = torch.meshgrid(torch.arange(h, dtype=f.dtype, device=f.device) + 0.5,
                                    torch.arange(w, dtype=f.dtype, device=f.device) + 0.5,
                                    indexing="ij")
            anchors = torch.stack([xs, ys], -1).reshape(1, h * w, 2)
            d = self.dfl(box)
            x1y1, x2y2 = anchors - d[..., :2], anchors + d[..., 2:]
            boxes.append(torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * stride)
            scores.append(cls.sigmoid())
        return torch.cat([torch.cat(boxes, 1), torch.cat(scores, 1)], -1)


class Concat(nn.Module):
    """Placeholder of the ultralytics ``Concat`` layer (no parameters): keeps
    the layer indices, and so the state-dict names, of ``yolov8.yaml``."""

    def forward(self, xs):
        return torch.cat(xs, 1)


class YOLOv8(nn.Module):
    """ultralytics yolov8.yaml topology, its layers at their indices."""

    def __init__(self, cfg: YOLOv8Config):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3 = cfg.ch(64), cfg.ch(128), cfg.ch(256)
        c4, c5 = cfg.ch(512), cfg.ch(1024)
        n1, n2 = cfg.n(3), cfg.n(6)
        up = lambda: nn.Upsample(scale_factor=2, mode="nearest")  # noqa: E731
        self.model = nn.ModuleList([
            Conv(3, c1, 3, 2), Conv(c1, c2, 3, 2), C2f(c2, c2, n1, True),        # 0-2
            Conv(c2, c3, 3, 2), C2f(c3, c3, n2, True),                           # 3-4 (P3)
            Conv(c3, c4, 3, 2), C2f(c4, c4, n2, True),                           # 5-6 (P4)
            Conv(c4, c5, 3, 2), C2f(c5, c5, n1, True), SPPF(c5, c5),             # 7-9 (P5)
            up(), Concat(), C2f(c5 + c4, c4, n1, False),                         # 10-12
            up(), Concat(), C2f(c4 + c3, c3, n1, False),                         # 13-15
            Conv(c3, c3, 3, 2), Concat(), C2f(c3 + c4, c4, n1, False),           # 16-18
            Conv(c4, c4, 3, 2), Concat(), C2f(c4 + c5, c5, n1, False),           # 19-21
            Detect(cfg, (c3, c4, c5)),                                           # 22
        ])

    def forward(self, x):
        """``[B, H, W, 3]`` RGB in [0, 1] (H, W multiples of 32) ->
        ``[B, N, 4 + nc]``."""
        m = self.model
        x = m[2](m[1](m[0](x.permute(0, 3, 1, 2))))
        p3 = m[4](m[3](x))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        h12 = m[12](m[11]([m[10](p5), p4]))
        h15 = m[15](m[14]([m[13](h12), p3]))
        h18 = m[18](m[17]([m[16](h15), h12]))
        h21 = m[21](m[20]([m[19](h18), p5]))
        return m[22]([h15, h18, h21])


# --------------------------------------------------------------------------
# Host-side pre/postprocessing (ultralytics predict path)
# --------------------------------------------------------------------------


def letterbox_np(image: np.ndarray, imgsz: int = 640, stride: int = 32):
    """Minimal-rectangle letterbox (ultralytics LetterBox, auto=True,
    center=True, colour 114): scale to fit, pad each side up to a stride
    multiple, padding split between both sides.

    Returns (padded image, ratio, (left, top) pad)."""
    from ..data.image import resize_linear

    h, w = image.shape[:2]
    r = min(imgsz / h, imgsz / w)
    nw, nh = round(w * r), round(h * r)
    dw, dh = (-nw) % stride / 2, (-nh) % stride / 2
    if (nw, nh) != (w, h):
        image = resize_linear(image, nh, nw)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (image.ndim - 2)
    return np.pad(image, pad, constant_values=114), r, (left, top)


def nms_np(boxes_xywh, scores, conf_thres: float = 0.25, iou_thres: float = 0.7,
           max_det: int = 300):
    """Per-class NMS on the host (ultralytics non_max_suppression defaults).
    boxes_xywh [N, 4], scores [N, nc] -> (boxes_xywh [M, 4], conf [M],
    cls [M])."""
    cls = scores.argmax(-1)
    conf = scores.max(-1)
    keep0 = conf > conf_thres
    boxes_xywh, conf, cls = boxes_xywh[keep0], conf[keep0], cls[keep0]
    if len(conf) == 0:
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))
    x1 = boxes_xywh[:, 0] - boxes_xywh[:, 2] / 2
    y1 = boxes_xywh[:, 1] - boxes_xywh[:, 3] / 2
    x2 = x1 + boxes_xywh[:, 2]
    y2 = y1 + boxes_xywh[:, 3]
    # per-class offset keeps one pass class-aware
    off = cls.astype(np.float32) * 7680.0
    order = conf.argsort()[::-1]
    keep = []
    xx1, yy1, xx2, yy2 = x1 + off, y1 + off, x2 + off, y2 + off
    areas = (x2 - x1) * (y2 - y1)
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        iw = np.maximum(0.0, np.minimum(xx2[i], xx2[rest]) - np.maximum(xx1[i], xx1[rest]))
        ih = np.maximum(0.0, np.minimum(yy2[i], yy2[rest]) - np.maximum(yy1[i], yy1[rest]))
        inter = iw * ih
        iou = inter / (areas[i] + areas[rest] - inter + 1e-9)
        order = rest[iou <= iou_thres]
    keep = np.asarray(keep, np.int64)
    return boxes_xywh[keep], conf[keep], cls[keep]


def scale_boxes_np(boxes_xywh, ratio: float, pad_lt, orig_hw):
    """Letterboxed-image xywh -> original-image xywh, centres clipped."""
    b = np.asarray(boxes_xywh, np.float32).copy()
    b[:, 0] = (b[:, 0] - pad_lt[0]) / ratio
    b[:, 1] = (b[:, 1] - pad_lt[1]) / ratio
    b[:, 2:] = b[:, 2:] / ratio
    h, w = orig_hw
    b[:, 0] = b[:, 0].clip(0, w)
    b[:, 1] = b[:, 1].clip(0, h)
    return b
