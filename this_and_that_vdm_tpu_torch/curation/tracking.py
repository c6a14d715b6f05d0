"""Click-to-mask tracking: SAM on the first frame, XMem through the clip
(counterpart of ``curation/tracking.py``).

Covers the reference's Track-Anything stack (track_anything_code/) and
curation_pipeline/tracking_by_keypoint.py: the point of ``data.txt`` ->
a SAM mask of the first frame -> video-object propagation -> one
``mask_N.png`` a frame.  The segmenter and the propagator are injectable.
``XMemPropagator`` loads a published ``XMem-s012.pth`` into the port's XMem
(``models/xmem.py``, ``curation/xmem_tracker.py``); without a checkpoint the
template propagator (sum of squared differences, as ``cv2.matchTemplate``
with ``TM_SQDIFF``) keeps the tool running.

Everything runs on the card unless ``device="cpu"``; a missing card raises.
Frames are read by content (``utils/video_io.read_image``) and masks written
as PNG (``write_png``), so none of this needs cv2.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.video_io import read_image, write_png
from .detectors import PointSegmenter, _from_state_dict, perception_device
from .painters import mask_painter, point_painter
from .xmem_tracker import DEFAULT_CONFIG, MaskMapper, XMemInferenceCore, xmem_propagator


def _sqdiff_map(frame: torch.Tensor, tmpl: torch.Tensor) -> torch.Tensor:
    """``cv2.matchTemplate(frame, tmpl, TM_SQDIFF)``: ``[H, W, C]`` and
    ``[h, w, C]`` -> ``[H-h+1, W-w+1]``, in float64 from integer pixels, so
    every sum is exact whatever order it is taken in (no FFT)."""
    h, w = tmpl.shape[:2]
    ho, wo = frame.shape[0] - h + 1, frame.shape[1] - w + 1
    sq = torch.nn.functional.pad((frame * frame).sum(-1).cumsum(0).cumsum(1), (1, 0, 1, 0))
    win = sq[h:, w:] - sq[:-h, w:] - sq[h:, :-w] + sq[:-h, :-w]
    corr = frame.new_zeros(ho, wo)
    for i in range(h):
        rows = frame[i:i + ho].unfold(1, w, 1)  # [ho, wo, C, w]
        corr += torch.einsum("yxcw,wc->yx", rows, tmpl[i])
    return win - 2.0 * corr + (tmpl * tmpl).sum()


def template_mask_propagator(frames_rgb: Sequence[np.ndarray], first_mask: np.ndarray,
                             device: str = "cuda") -> List[np.ndarray]:
    """Fallback propagation: track the mask's bounding box by the least sum
    of squared differences (the first minimum in row-major order, as
    ``cv2.minMaxLoc`` takes it), carrying the mask's shape along and taking
    each frame's match as the next template."""
    dev = perception_device(device)
    ys, xs = np.nonzero(first_mask)
    if len(xs) == 0:
        return [first_mask.astype(bool) for _ in frames_rgb]
    x0, y0 = int(xs.min()), int(ys.min())
    w, h = int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)
    tmask = first_mask[y0:y0 + h, x0:x0 + w]
    masks = [first_mask.astype(bool)]
    template = torch.from_numpy(np.array(frames_rgb[0][y0:y0 + h, x0:x0 + w])).to(dev)
    for fr in frames_rgb[1:]:
        fr_t = torch.from_numpy(np.array(fr)).to(dev)  # a copy: frames may be read-only
        res = _sqdiff_map(fr_t.double(), template.double())
        by, bx = divmod(int(torch.argmin(res)), res.shape[1])
        m = np.zeros(first_mask.shape, bool)
        m[by:by + h, bx:bx + w] = tmask[:m.shape[0] - by, :m.shape[1] - bx]
        masks.append(m)
        template = fr_t[by:by + h, bx:bx + w]
    return masks


def load_xmem(checkpoint: str, device: str = "cuda"):
    """An ``XMem-s012.pth`` state dict (``torch.load(weights_only=True)``)
    loaded strictly into ``models/xmem.XMem`` on the device, in eval mode.
    A single-object file's 4-channel ``value_encoder.conv1`` gets a zero
    fifth channel (network.py ``init_as_zero_if_needed``)."""
    from ..models.xmem import XMem

    dev = perception_device(device)
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    w = sd.get("value_encoder.conv1.weight")
    if w is not None and w.shape[1] == 4:
        sd["value_encoder.conv1.weight"] = torch.cat([w, w.new_zeros(w.shape[0], 1,
                                                                    *w.shape[2:])], 1)
    return _from_state_dict(XMem, sd).to(dev).eval()


class XMemPropagator:
    """VOS propagation with the port's XMem from a published checkpoint:
    ``(frames_rgb, first_mask) -> list of bool masks``."""

    def __init__(self, checkpoint: str, device: str = "cuda"):
        self.model = load_xmem(checkpoint, device)
        self._propagate = xmem_propagator(self.model)

    def __call__(self, frames_rgb, first_mask):
        return self._propagate(frames_rgb, first_mask)


class BaseTracker:
    """Per-frame XMem tracking over indexed masks (reference
    track_anything_code/tracker/base_tracker.py:30-108): arbitrary labels
    mapped to contiguous ids, one memory step a frame, the argmax as an
    indexed mask, and the overlay.  ``xmem`` is a ``models/xmem.XMem``
    (``load_xmem`` reads a checkpoint)."""

    def __init__(self, xmem, config: Optional[Dict] = None, device: str = "cuda"):
        model = xmem.to(perception_device(device)).eval()
        self.core = XMemInferenceCore(model, config or DEFAULT_CONFIG)
        self.mapper = MaskMapper()

    def clear_memory(self):
        self.core.clear_memory()
        self.mapper = MaskMapper()

    def track(self, frame_rgb: np.ndarray, first_frame_annotation=None):
        """frame_rgb uint8 ``[H, W, 3]``; annotation an indexed mask or None.
        Returns (indexed mask, indexed mask, painted frame): the reference
        returns the mask twice in place of a logit map."""
        mask = None
        if first_frame_annotation is not None:
            mask, _ = self.mapper.convert_mask(np.asarray(first_frame_annotation))
            self.core.set_all_labels(list(self.mapper.remappings.values()))
        prob = self.core.step(frame_rgb.astype(np.float32) / 255.0, mask)
        out = torch.argmax(prob, 0).to(torch.uint8).cpu().numpy()
        final = np.zeros_like(out)
        for k, v in self.mapper.remappings.items():
            final[out == v] = k
        painted = frame_rgb
        for obj in range(1, int(final.max()) + 1):
            if np.any(final == obj):
                painted = mask_painter(painted, final == obj, mask_color=obj + 1)
        return final, final, painted


class TrackingAnything:
    """SAM + XMem (reference track_anything_code/model.py:14-45):
    ``first_frame_click`` segments the clicked object, ``generator`` carries
    a template mask through a clip."""

    def __init__(self, segmenter: PointSegmenter, xmem, config: Optional[Dict] = None,
                 device: str = "cuda"):
        self.segmenter = segmenter
        self.tracker = BaseTracker(xmem, config, device)

    def first_frame_click(self, image_rgb: np.ndarray, points_xy: np.ndarray, labels=None):
        mask = self.segmenter.predict_mask(image_rgb[:, :, ::-1], np.asarray(points_xy))
        painted = mask_painter(image_rgb, mask)
        painted = point_painter(painted, [tuple(p) for p in points_xy], point_radius=8)
        return mask, mask, painted

    def generator(self, images: Sequence[np.ndarray], template_mask: np.ndarray):
        masks, logits, painted = [], [], []
        for i, img in enumerate(images):
            m, lg, p = self.tracker.track(img, template_mask if i == 0 else None)
            masks.append(m)
            logits.append(lg)
            painted.append(p)
        return masks, logits, painted


def track_by_keypoint(instance_dir: str, segmenter: PointSegmenter,
                      propagator: Optional[Callable] = None, store_dir: Optional[str] = None,
                      device: str = "cuda") -> List[np.ndarray]:
    """The first point of ``data.txt`` -> SAM mask of ``im_0`` -> propagated
    masks -> ``store_dir/mask_N.png`` (reference tracking_by_keypoint.py:103-133).
    Without a propagator, the template one runs on ``device``."""
    from ..data.rasterize import read_gesture_file

    perception_device(device)
    if propagator is None:
        def propagator(frames, first):
            return template_mask_propagator(frames, first, device)
    points = read_gesture_file(os.path.join(instance_dir, "data.txt"))
    frames = []
    while os.path.exists(os.path.join(instance_dir, f"im_{len(frames)}.jpg")):
        frames.append(read_image(os.path.join(instance_dir, f"im_{len(frames)}.jpg")))
    _, x, y = points[0]
    first_mask = segmenter.predict_mask(np.ascontiguousarray(frames[0][..., ::-1]),
                                        np.array([[int(x), int(y)]]))
    masks = propagator(frames, np.asarray(first_mask))
    if store_dir:
        os.makedirs(store_dir, exist_ok=True)
        for i, m in enumerate(masks):
            write_png(os.path.join(store_dir, f"mask_{i}.png"), m.astype(np.uint8) * 255)
    return masks
