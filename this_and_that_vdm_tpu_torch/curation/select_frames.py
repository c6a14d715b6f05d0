"""This/That auto-labeler: gripper open/close -> gesture points -> data.txt
(counterpart of ``curation/select_frames.py``).

Replicates the algorithm of reference
curation_pipeline/select_frame_with_this_that.py with the perception models
injected (detectors.py):

* parse gripper open/close from ``policy_out.pkl`` actions — first 0.0 then
  the first following 1.0 (:221-238);
* YOLO detection around action start with 3-frame voting (pick the frame
  whose two boxes are closest / a lone box scores 100), sanity thresholds:
  box >15px, centers <90px apart, <=2 boxes (:27-87, :91-163);
* merge start/end points when <30px apart (:153-158);
* optional SAM mask from point + the detections' bounding box (:270-287);
* resample to F frames with the standard gap algorithm **starting at index 1**
  (:291-312) and remap gesture frame indices to nearest resampled frame
  (:326-337);
* write ``im_*.jpg`` + ``data.txt`` (``frame_idx x y`` lines) + ``lang.txt``
  (:316-349); soft-failure accounting via returned messages (:406-431).

Frames are read by content (``utils/video_io.read_image``: PNG bytes or a
JPEG) and flipped to the BGR order ``cv2.imread`` gives; ``mask_0.png`` is
written by the port's PNG writer, so neither cv2 nor PIL is needed.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
from typing import List, Optional, Tuple

import numpy as np

from ..utils.video_io import read_image, write_png
from .detectors import BoxDetector, PointSegmenter


def imread_bgr(path: str) -> np.ndarray:
    """``cv2.imread(path)``: the frame in BGR order, read by content."""
    return np.ascontiguousarray(read_image(path)[..., ::-1])


def read_center_point(detector: BoxDetector, image_bgr: np.ndarray):
    """Returns ([cx, cy, pair_distance], edge_points) or (None, None)."""
    boxes = detector.boxes_xywh(image_bgr)
    centers: List[List[float]] = []
    edges: List[Tuple[float, float]] = []
    for x, y, w, h in boxes:
        if w <= 15 or h <= 15:
            return None, None
        for prev in centers:
            if x - prev[0] >= 90 or y - prev[1] >= 90:
                return None, None
        edges.extend(
            [(x + w // 2, y + h // 2), (x - w // 2, y + h // 2),
             (x - w // 2, y - h // 2), (x + w // 2, y - h // 2)]
        )
        centers.append([float(x), float(y)])
    if len(centers) == 0 or len(centers) > 2:
        return None, None
    if len(centers) == 2:
        (x1, y1), (x2, y2) = centers
        dist = math.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
        return [(x1 + x2) / 2, (y1 + y2) / 2, dist], edges
    return [*centers[0], 100.0], edges


def parse_action_range(policy_path: str) -> Optional[Tuple[int, int]]:
    """First 0.0 action then first following 1.0 (gripper close -> open)."""
    with open(policy_path, "rb") as f:
        policy = pickle.load(f)
    start = end = None
    for idx, item in enumerate(policy):
        value = item["actions"][-1]
        if start is None and value == 0.0:
            start = idx
        if start is not None and end is None and value == 1.0:
            end = idx
    if start is None or end is None:
        return None
    return start, end


def detect_gripper(detector: BoxDetector, input_dir: str, action_start: int,
                   action_end: int):
    """Returns ((points, [start_idx, end_idx]), bbox_xminmax, message)."""
    candidates, edge_points = [], []
    for off in range(3):
        path = os.path.join(input_dir, f"im_{action_start + off}.jpg")
        if not os.path.exists(path):
            continue
        point, edges = read_center_point(detector, imread_bgr(path))
        if off == 0 and point is None:
            return None, None, "Cannot find the first contact point!"
        if point is not None:
            candidates.append([action_start + off, point])
            edge_points.extend(edges)
    if not candidates:  # e.g. policy_out longer than the frame sequence:
        # soft-fail with a message instead of IndexError
        return None, None, "Cannot find the first contact point!"
    candidates.sort(key=lambda c: c[1][2])  # closest box pair wins
    first_point = candidates[0][1][:2]
    start_idx = candidates[0][0]

    xs = sorted(p[0] for p in edge_points)
    ys = sorted(p[1] for p in edge_points)
    bbox = (int(xs[0]), int(xs[-1]), int(ys[0]), int(ys[-1]))  # xmin,xmax,ymin,ymax

    last_path = os.path.join(input_dir, f"im_{action_end}.jpg")
    last_point, _ = read_center_point(detector, imread_bgr(last_path))
    if last_point is None:
        return None, bbox, "Cannot find the last contact point!"
    last_point = last_point[:2]

    if math.dist(first_point, last_point) <= 30:  # merge
        return ([first_point], [start_idx, action_end]), bbox, "Success!"
    return ([first_point, last_point], [start_idx, action_end]), bbox, "Success!"


def resample_orders(num_input: int, num_needed: int) -> List[int]:
    """Gap resampling starting at index 1 (curation variant, :291-312)."""
    division = num_input // num_needed
    remain = (num_input % num_needed) - 1
    gaps = [division] * (num_needed - 1)
    for idx in range(remain):
        if idx % 2 == 0:
            gaps[idx // 2] += 1
        else:
            gaps[-1 * (1 + idx // 2)] += 1
    orders = [1]
    for g in gaps:
        orders.append(orders[-1] + g)
    return orders


def remap_indices(old_indices: List[int], orders: List[int]) -> List[int]:
    """Nearest resampled position for each original gesture frame index."""
    out = []
    for old in old_indices:
        out.append(int(np.argmin([abs(old - o) for o in orders])))
    return out


def process_instance(
    input_dir: str,
    store_dir: str,
    detector: BoxDetector,
    segmenter: Optional[PointSegmenter] = None,
    total_frames_needed: int = 14,
    max_original_input_tolerate: int = 56,
) -> Tuple[bool, str]:
    """One trajectory folder -> curated 14-frame instance (manage_seq_range)."""
    n = sum(1 for f in os.listdir(input_dir) if f.startswith("im_"))
    for i in range(n):
        if not os.path.exists(os.path.join(input_dir, f"im_{i}.jpg")):
            return False, "Invalid error"
    if n > max_original_input_tolerate:
        return False, "The number of frames is too long"
    if n < total_frames_needed:
        return False, "The number of frames is too short"

    rng = parse_action_range(os.path.join(input_dir, "policy_out.pkl"))
    if rng is None:
        return False, "We cannot read an action_start or action_end code!"
    action_start, action_end = rng

    info, bbox, message = detect_gripper(detector, input_dir, action_start, action_end)
    if info is None:
        return False, message
    points, old_idx = info

    # fresh output dir per instance: data.txt is written in append mode
    # (reference semantics) and the reference wipes its destination root per
    # run — without this a resumed run appends duplicate gesture lines
    shutil.rmtree(store_dir, ignore_errors=True)
    os.makedirs(store_dir, exist_ok=True)
    if segmenter is not None and bbox is not None:
        base = imread_bgr(os.path.join(input_dir, "im_0.jpg"))
        xmin, xmax, ymin, ymax = bbox
        mask = segmenter.predict_mask(
            base, np.array([[int(points[0][0]), int(points[0][1])]]),
            np.array([xmin, ymin, xmax, ymax]),
        )
        write_png(os.path.join(store_dir, "mask_0.png"), mask.astype(np.uint8) * 255)

    orders = resample_orders(n, total_frames_needed)
    if orders[-1] >= n:
        return False, "Invalid error"
    for new_i, src_i in enumerate(orders):
        shutil.copyfile(os.path.join(input_dir, f"im_{src_i}.jpg"),
                        os.path.join(store_dir, f"im_{new_i}.jpg"))

    mapped = remap_indices(old_idx, orders)
    with open(os.path.join(store_dir, "data.txt"), "a") as f:
        f.write(f"{mapped[0]} {points[0][0]} {points[0][1]}\n")
        if len(points) == 2:
            f.write(f"{mapped[1]} {points[1][0]} {points[1][1]}\n")
    shutil.copyfile(os.path.join(input_dir, "lang.txt"),
                    os.path.join(store_dir, "lang.txt"))
    return True, "Success!"


def process_dataset(input_root: str, output_root: str, detector, segmenter=None,
                    **kwargs) -> dict:
    """Batch run with soft-failure accounting (reference message_dict)."""
    os.makedirs(output_root, exist_ok=True)
    messages: dict = {}
    for name in sorted(os.listdir(input_root)):
        src = os.path.join(input_root, name)
        if not os.path.isdir(src):
            continue
        ok, msg = process_instance(
            src, os.path.join(output_root, name), detector, segmenter, **kwargs
        )
        messages[msg] = messages.get(msg, 0) + 1
        if not ok:
            shutil.rmtree(os.path.join(output_root, name), ignore_errors=True)
    return messages


def main(argv=None):
    """Batch CLI (reference select_frame_with_this_that.py:358-431):
    ``python -m this_and_that_vdm_tpu_torch.curation.select_frames IN OUT
    --yolo gripper.pt [--sam sam_vit_h.pth] [--device cpu]``.  The models
    (either backend) run on the card unless ``--device cpu``."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="This/That auto-labeler over a dataset root")
    p.add_argument("input_root")
    p.add_argument("output_root")
    p.add_argument("--yolo", required=True, help="ultralytics gripper weights")
    p.add_argument("--yolo-backend", default="native",
                   choices=("native", "torch"),
                   help="native = the port's YOLOv8 (models/yolov8.py); "
                        "torch = external ultralytics package")
    p.add_argument("--sam", default=None, help="segment-anything checkpoint")
    p.add_argument("--sam-type", default="vit_h")
    p.add_argument("--sam-backend", default="native",
                   choices=("native", "torch"),
                   help="native = the port's SAM (models/sam.py); torch = "
                        "external segment-anything package")
    p.add_argument("--device", default="cuda",
                   help="device of the models (default: the CUDA card; cpu)")
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--max-input-frames", type=int, default=56)
    args = p.parse_args(argv)

    from .detectors import (
        NativeGripperDetector, NativeSAMSegmenter, SAMSegmenter,
        UltralyticsGripperDetector,
    )

    if args.yolo_backend == "native":
        detector = NativeGripperDetector(args.yolo, device=args.device)
    else:
        detector = UltralyticsGripperDetector(args.yolo, device=args.device)
    segmenter = None
    if args.sam and args.sam_backend == "native":
        segmenter = NativeSAMSegmenter(args.sam, args.sam_type, device=args.device)
    elif args.sam:
        segmenter = SAMSegmenter(args.sam, args.sam_type, device=args.device)
    messages = process_dataset(
        args.input_root, args.output_root, detector, segmenter,
        total_frames_needed=args.frames,
        max_original_input_tolerate=args.max_input_frames,
    )
    print(json.dumps(messages, indent=2))  # soft-failure accounting
    return messages


if __name__ == "__main__":
    main()
