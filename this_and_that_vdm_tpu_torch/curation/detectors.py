"""Perception models behind the curation stages (counterpart of
``curation/detectors.py``).

Small protocols keep the algorithms testable with fakes.  The native
wrappers run the port's YOLOv8, SAM, RAFT and FlowFormer (``models/``) on the card by
default, in fp32 with TF32 off (they hold to a full-fp32 reference), and
raise rather than fall back to the CPU when no card is present; ``device=
"cpu"`` runs them on the CPU.  The external-package wrappers (ultralytics,
segment-anything, a vendored FlowFormer) load only when called and take the
same ``device``.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Protocol

import numpy as np


class BoxDetector(Protocol):
    """Returns [N, 4] xywh (center x, center y, width, height) boxes."""

    def boxes_xywh(self, image_bgr: np.ndarray) -> np.ndarray: ...


class PointSegmenter(Protocol):
    """SAM-like: mask from positive points (+ optional xyxy box prompt)."""

    def predict_mask(self, image_bgr: np.ndarray, points_xy: np.ndarray,
                     box_xyxy: Optional[np.ndarray] = None) -> np.ndarray: ...


class LabeledPointSegmenter(Protocol):
    """SAM-like with positive/negative point labels."""

    def predict_mask_labeled(self, image_rgb: np.ndarray, points_xy: np.ndarray,
                             labels: np.ndarray) -> np.ndarray: ...


def perception_device(device: str):
    """The torch device of a native wrapper.  On CUDA it must exist (no
    quiet CPU fallback), and TF32 is turned off for matmuls and cuDNN
    convolutions, process-wide: these models are held to fp32 math."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is "
                               "false; pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _from_state_dict(build, state_dict):
    """``build()`` on the meta device (no initialisation spent on weights
    about to be replaced), then ``state_dict`` (numpy or torch values)
    loaded strictly into it."""
    import torch

    with torch.device("meta"):
        model = build()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model


class UltralyticsGripperDetector:
    """YOLOv8 gripper detector through the ultralytics package."""

    def __init__(self, weight_path: str, device: str = "cuda"):
        dev = perception_device(device)
        from ultralytics import YOLO  # optional dependency

        self.model = YOLO(weight_path)
        # ultralytics names a card by its index
        self.predict_device = "cpu" if dev.type == "cpu" else str(dev.index or 0)

    def boxes_xywh(self, image_bgr: np.ndarray) -> np.ndarray:
        # ultralytics treats numpy sources as BGR and flips them itself
        pred = self.model.predict(source=image_bgr, save=False, device=self.predict_device)[0]
        if not hasattr(pred, "boxes"):
            return np.zeros((0, 4), np.float32)
        return np.asarray(pred.boxes.xywh.detach().cpu().numpy(), np.float32)


class NativeGripperDetector:
    """The port's YOLOv8 with the ultralytics predict contract: BGR numpy
    in, ``[N, 4]`` xywh centre boxes out.  Loads an ultralytics ``.pt``
    through the shell unpickler (no ultralytics package); the scale (n/s/m,
    classes, DFL bins) comes from the weights.  ``model`` takes a built
    ``models/yolov8.YOLOv8`` instead."""

    def __init__(self, weight_path: Optional[str] = None, model=None, imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, device: str = "cuda"):
        from ..models.yolov8 import YOLOv8, YOLOv8Config

        self.device = perception_device(device)
        if model is None:
            from ..weights.convert import load_ultralytics_state_dict

            sd = load_ultralytics_state_dict(weight_path)
            model = _from_state_dict(lambda: YOLOv8(YOLOv8Config.from_state_dict(sd)), sd)
        self.model = model.to(self.device).eval()
        self.imgsz, self.conf, self.iou = imgsz, conf, iou

    def predict(self, image_bgr: np.ndarray):
        """(raw predictions [N, 4 + nc] of the letterboxed image, ratio,
        pad): the model's output before NMS."""
        import torch

        from ..models.yolov8 import letterbox_np

        padded, ratio, pad = letterbox_np(np.asarray(image_bgr), self.imgsz)
        x = np.ascontiguousarray(padded[..., ::-1], np.float32) / 255.0  # BGR -> RGB
        with torch.no_grad():
            pred = self.model(torch.from_numpy(x[None]).to(self.device))
        return pred[0].float().cpu().numpy(), ratio, pad

    def boxes_xywh(self, image_bgr: np.ndarray) -> np.ndarray:
        from ..models.yolov8 import nms_np, scale_boxes_np

        pred, ratio, pad = self.predict(image_bgr)
        boxes, _conf, _cls = nms_np(pred[:, :4], pred[:, 4:], self.conf, self.iou)
        return scale_boxes_np(boxes, ratio, pad, np.shape(image_bgr)[:2])


class SAMSegmenter:
    """segment-anything point/box segmenter through its own package."""

    def __init__(self, checkpoint: str, model_type: str = "vit_h", device: str = "cuda"):
        dev = perception_device(device)
        from segment_anything import SamPredictor, sam_model_registry  # optional dependency

        sam = sam_model_registry[model_type](checkpoint=checkpoint).to(dev)
        self.predictor = SamPredictor(sam)

    def predict_mask(self, image_bgr, points_xy, box_xyxy=None) -> np.ndarray:
        self.predictor.set_image(np.uint8(image_bgr), image_format="BGR")
        masks, _scores, _ = self.predictor.predict(
            point_coords=np.asarray(points_xy), point_labels=np.ones(len(points_xy)),
            box=None if box_xyxy is None else np.asarray(box_xyxy)[None, :],
            multimask_output=False)
        return masks[0]

    def predict_mask_labeled(self, image_rgb, points_xy, labels) -> np.ndarray:
        self.predictor.set_image(np.uint8(image_rgb))
        masks, _scores, _ = self.predictor.predict(
            point_coords=np.asarray(points_xy), point_labels=np.asarray(labels),
            multimask_output=False)
        return masks[0]


class NativeSAMSegmenter:
    """The port's SAM with the SamPredictor contract: embed once per frame,
    predict per prompt.  Loads the published ``sam_vit_{b,l,h}*.pth`` (a
    plain state dict) or takes a built ``models/sam.Sam`` as ``model``.

    Prompts are padded to multiples of ``max_points`` slots with label -1,
    exactly as the JAX wrapper pads them: every slot is a token of the
    two-way decoder, so the padding changes the mask (20 points take 24
    slots).  A box rides as two corner points with labels 2 and 3.  The
    embedding of the last frame is kept, keyed by the frame's bytes."""

    def __init__(self, checkpoint: Optional[str] = None, model_type: str = "vit_h", model=None,
                 max_points: int = 8, device: str = "cuda"):
        import torch

        from ..models import sam as sam_mod

        self.device = perception_device(device)
        if model is None:
            sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
            model = _from_state_dict(
                lambda: sam_mod.Sam(getattr(sam_mod.SamConfig, model_type)()), sd)
        self.model = model.to(self.device).eval()
        self.cfg = self.model.cfg
        self.max_points = max_points
        self.encodes = 0  # image encodes run (the cache's misses)
        self._cache_key = None
        self._cache = None

    def _set_image(self, image_rgb_uint8: np.ndarray):
        import torch

        from ..models.sam import preprocess_np

        img = np.ascontiguousarray(np.uint8(image_rgb_uint8))
        key = (img.shape, hashlib.sha1(img.tobytes()).hexdigest())
        if key == self._cache_key:
            return self._cache
        x, input_hw = preprocess_np(img, self.cfg.img_size)
        with torch.no_grad():
            emb = self.model.encode_image(torch.from_numpy(x).to(self.device))
        self.encodes += 1
        self._cache_key, self._cache = key, (emb, input_hw, img.shape[:2])
        return self._cache

    def _run(self, image_rgb, coords_xy, labels):
        import torch

        from ..models.sam import MASK_THRESHOLD, postprocess_masks, transform_coords_np

        emb, input_hw, orig_hw = self._set_image(image_rgb)
        n = len(coords_xy)
        slots = max(self.max_points, -(-n // self.max_points) * self.max_points)
        pts = np.zeros((1, slots, 2), np.float32)
        lbl = np.full((1, slots), -1, np.int64)
        pts[0, :n] = transform_coords_np(np.asarray(coords_xy, np.float32), orig_hw,
                                         self.cfg.img_size)
        lbl[0, :n] = np.asarray(labels, np.int64)
        with torch.no_grad():
            low_res, _iou = self.model.predict(emb, torch.from_numpy(pts).to(self.device),
                                               torch.from_numpy(lbl).to(self.device))
            # multimask_output=False -> mask token 0 (official predict path)
            masks = postprocess_masks(low_res[:, :1], input_hw, orig_hw, self.cfg.img_size)
        return (masks[0, 0] > MASK_THRESHOLD).cpu().numpy()

    def predict_mask(self, image_bgr, points_xy, box_xyxy=None) -> np.ndarray:
        coords = list(np.asarray(points_xy, np.float32))
        labels = [1] * len(coords)
        if box_xyxy is not None:
            b = np.asarray(box_xyxy, np.float32).reshape(4)
            coords += [b[:2], b[2:]]
            labels += [2, 3]
        return self._run(np.asarray(image_bgr)[..., ::-1], coords, labels)

    def predict_mask_labeled(self, image_rgb, points_xy, labels) -> np.ndarray:
        return self._run(np.asarray(image_rgb), np.asarray(points_xy, np.float32),
                         np.asarray(labels))


class FlowFormerFlow:
    """Adapter for a user-vendored FlowFormer (``flowformer_code``, which
    the reference does not ship): pad both frames to a multiple of 8
    (sintel-style), one forward, unpad."""

    def __init__(self, checkpoint: str, device: str = "cuda", flow_cfg=None):
        import torch

        self.device = perception_device(device)
        from flowformer_code.FlowFormer import build_flowformer  # vendored by the user

        if flow_cfg is None:
            from config.flowformer_config import get_cfg

            flow_cfg = get_cfg()
        self.torch = torch
        model = torch.nn.DataParallel(build_flowformer(flow_cfg))
        model.load_state_dict(torch.load(checkpoint, map_location="cpu"))
        self.model = model.module.to(self.device).eval()

    def __call__(self, prev_rgb: np.ndarray, next_rgb: np.ndarray) -> np.ndarray:
        torch = self.torch
        im1 = torch.from_numpy(prev_rgb).permute(2, 0, 1).float()[None]
        im2 = torch.from_numpy(next_rgb).permute(2, 0, 1).float()[None]
        h, w = im1.shape[-2:]
        pad_h, pad_w = (-h) % 8, (-w) % 8
        pad = [pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2]
        im1 = torch.nn.functional.pad(im1, pad, mode="replicate").to(self.device)
        im2 = torch.nn.functional.pad(im2, pad, mode="replicate").to(self.device)
        with torch.no_grad():
            flow_pre, _ = self.model(im1, im2)
        flow = flow_pre[0, :, pad[2]:pad[2] + h, pad[0]:pad[0] + w]
        return flow.permute(1, 2, 0).cpu().numpy()


class NativeRAFTFlow:
    """The port's RAFT with the FlowFn contract: (prev_rgb, next_rgb) uint8
    -> ``[H, W, 2]`` float32 flow.  Loads a published ``raft-things.pth``
    (``module.`` prefix stripped, widths from the shapes) or takes a built
    ``models/raft.RAFT`` as ``model``.  Frames are replicate-padded to a
    multiple of 8 (sintel-style) and the flow cropped back."""

    def __init__(self, checkpoint: Optional[str] = None, model=None, iters: int = 20,
                 device: str = "cuda"):
        import torch

        from ..models import raft as raft_mod

        self.device = perception_device(device)
        if model is None:
            state = torch.load(checkpoint, map_location="cpu", weights_only=True)
            sd = {k.removeprefix("module."): v for k, v in state.items()}
            model = _from_state_dict(
                lambda: raft_mod.RAFT(raft_mod.RAFTConfig.from_state_dict(sd)), sd)
        self.model = model.to(self.device).eval()
        self.iters = iters

    def __call__(self, prev_rgb: np.ndarray, next_rgb: np.ndarray) -> np.ndarray:
        import torch

        from ..models.raft import pad_to_multiple

        p1, (top, left, h, w) = pad_to_multiple(np.asarray(prev_rgb))
        p2, _ = pad_to_multiple(np.asarray(next_rgb))
        x1 = torch.from_numpy(p1.astype(np.float32)[None]).to(self.device)
        x2 = torch.from_numpy(p2.astype(np.float32)[None]).to(self.device)
        with torch.no_grad():
            flow = self.model(x1, x2, iters=self.iters)[1]
        return flow[0, top:top + h, left:left + w].cpu().numpy()


class NativeFlowFormerFlow:
    """The port's FlowFormer with the FlowFn contract: (prev_rgb, next_rgb)
    uint8 -> ``[H, W, 2]`` float32 flow.  Loads a ``flowformer_params_save``
    ``.npz`` (the config from the archive unless ``cfg`` is given; the JAX
    package's archives load as they are) or takes a built
    ``models/flowformer.FlowFormer`` as ``model``.  ``iters`` defaults to
    the config's ``decoder_depth``; frames are replicate-padded to a
    multiple of 8 and the flow cropped back."""

    def __init__(self, checkpoint: Optional[str] = None, model=None, cfg=None, iters: int = 0,
                 device: str = "cuda"):
        from ..models import flowformer as ff_mod

        self.device = perception_device(device)
        if model is None:
            model = ff_mod.load_flowformer(checkpoint, cfg)
        self.model = model.to(self.device).eval()
        self.cfg = self.model.cfg
        self.iters = iters or self.cfg.decoder_depth

    def __call__(self, prev_rgb: np.ndarray, next_rgb: np.ndarray) -> np.ndarray:
        import torch

        from ..models.flowformer import flowformer_forward, pad_to_multiple

        p1, (top, left, h, w) = pad_to_multiple(np.asarray(prev_rgb))
        p2, _ = pad_to_multiple(np.asarray(next_rgb))
        x1 = torch.from_numpy(p1.astype(np.float32)[None]).to(self.device)
        x2 = torch.from_numpy(p2.astype(np.float32)[None]).to(self.device)
        with torch.no_grad():
            flow = flowformer_forward(self.model, x1, x2, iters=self.iters)[1]
        return flow[0, top:top + h, left:left + w].cpu().numpy()


def farneback_flow(prev_rgb: np.ndarray, next_rgb: np.ndarray) -> np.ndarray:
    """Dense optical flow by cv2's Farneback: the trajectory tools' default
    where no flow checkpoint is given.  Needs cv2, and only when called."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("farneback_flow needs cv2, which is not installed; give a RAFT "
                           "checkpoint (--raft) for the port's own flow network") from None
    g1 = cv2.cvtColor(prev_rgb, cv2.COLOR_RGB2GRAY)
    g2 = cv2.cvtColor(next_rgb, cv2.COLOR_RGB2GRAY)
    return cv2.calcOpticalFlowFarneback(g1, g2, None, 0.5, 3, 15, 3, 5, 1.2, 0)
