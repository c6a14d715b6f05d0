"""Optical-flow trajectories + motion statistics (counterpart of
``curation/trajectory.py``).

Replicates reference scripts/generate_traj.py (flow -> moving-point mask ->
centered start point -> chained local-mean trajectory with expanding search
-> ``traj_data.txt``) and scripts/motion_stats.py (per-video mean flow
magnitude -> the N(35.3, 18.5)/N(25, 10) constants in the training YAMLs).

The flow backend is injectable: the port's RAFT (models/raft.py, ``--raft
ckpt``, published raft-things/sintel checkpoints) or FlowFormer
(models/flowformer.py, ``--native-flowformer archive.npz``), both on the
card unless ``--device cpu``; a vendored FlowFormer (as the reference
expects its user to do); or cv2's Farneback (detectors.farneback_flow,
which needs cv2).
Frames are read by content (``utils/video_io.read_image``), so PNG bytes
need neither cv2 nor PIL.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.video_io import read_image
from .detectors import farneback_flow

FlowFn = Callable[[np.ndarray, np.ndarray], np.ndarray]  # (H,W,3)x2 -> (H,W,2)


def filter_uv(flow: np.ndarray, threshold_factor: float = 0.2) -> np.ndarray:
    """Zero out flow below threshold_factor * max magnitude
    (reference generate_traj.py:171-182)."""
    mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    thr = threshold_factor * mag.max() if mag.max() > 0 else 0.0
    out = flow.copy()
    out[mag < thr] = 0.0
    return out


def compute_flows(frames_rgb: np.ndarray, flow_fn: FlowFn = farneback_flow):
    """Consecutive-frame flows: [F-1, H, W, 2]."""
    return np.stack(
        [flow_fn(frames_rgb[i], frames_rgb[i + 1]) for i in range(len(frames_rgb) - 1)]
    )


def pick_start_point(flow: np.ndarray, threshold_factor: float = 0.2):
    """Most-centered moving point of the first flow field (:311-347)."""
    f = filter_uv(flow, threshold_factor)
    moving = np.argwhere((f[..., 0] != 0) | (f[..., 1] != 0))  # (row, col)
    if len(moving) == 0:
        return None
    center = np.array([flow.shape[0] / 2, flow.shape[1] / 2])
    return tuple(moving[np.argmin(np.linalg.norm(moving - center, axis=1))])


def chain_trajectory(
    flows: np.ndarray,
    start_rc: Tuple[int, int],
    threshold_factor: float = 0.2,
    base_radius: int = 5,
    max_radius: int = 60,
) -> List[Tuple[float, float]]:
    """Chain mean local flow into a per-frame trajectory with an expanding
    search window when no moving pixels are nearby (:357-397)."""
    h, w = flows.shape[1:3]
    traj = [(float(start_rc[0]), float(start_rc[1]))]
    r, c = float(start_rc[0]), float(start_rc[1])
    for f in flows:
        f = filter_uv(f, threshold_factor)
        radius = base_radius
        move = None
        while radius <= max_radius:
            r0, r1 = max(int(r) - radius, 0), min(int(r) + radius + 1, h)
            c0, c1 = max(int(c) - radius, 0), min(int(c) + radius + 1, w)
            patch = f[r0:r1, c0:c1]
            mask = (patch[..., 0] != 0) | (patch[..., 1] != 0)
            if mask.any():
                move = patch[mask].mean(axis=0)  # (u, v) = (dx, dy)
                break
            radius *= 2
        if move is None:
            move = np.zeros(2)
        c = float(np.clip(c + move[0], 0, w - 1))
        r = float(np.clip(r + move[1], 0, h - 1))
        traj.append((r, c))
    return traj


def sample_sam_points(
    flow: np.ndarray,
    n_pos: int = 20,
    n_neg: int = 0,
    rng: Optional[np.random.RandomState] = None,
):
    """Positive points from moving pixels, negatives from static pixels
    (reference generate_traj.py:260-284; xy order).  Returns (coords, labels)
    or None when fewer than ``n_pos`` moving pixels exist (the reference
    discards the sample, :263-265)."""
    rng = rng or np.random.RandomState(0)
    nz = np.nonzero(flow)  # (rows, cols, channel) over both flow channels
    rows, cols = nz[0], nz[1]
    if len(rows) < n_pos:
        return None
    pick = rng.choice(len(rows), n_pos, replace=False)
    pos = np.stack([cols[pick], rows[pick]], axis=1).astype(np.float64)
    labels = [np.ones(len(pos))]
    coords = [pos]
    if n_neg:
        static = (flow[..., 0] == 0) & (flow[..., 1] == 0)
        srows, scols = np.nonzero(static)
        n_static = len(srows)
        if n_static:
            skip_prob = min(1.0, 2 * n_neg / max(n_static, 1))
            keep = rng.random_sample(n_static) < skip_prob
            if keep.any():
                neg = np.stack([scols[keep], srows[keep]], axis=1).astype(np.float64)
                coords.append(neg)
                labels.append(np.zeros(len(neg)))
    return np.concatenate(coords, 0), np.concatenate(labels, 0)


def pick_start_point_sam(
    image_rgb: np.ndarray,
    flow: np.ndarray,
    segmenter,
    rng: Optional[np.random.RandomState] = None,
    n_pos: int = 20,
    n_neg: int = 0,
    interior: int = 15,
    max_retries: int = 100,
    threshold_factor: float = 0.2,
) -> Optional[Tuple[int, int]]:
    """Reference SAM stage (generate_traj.py:289-347): sample moving points
    -> SAM mask -> random in-mask start point whose +-``interior``
    neighbourhood lies fully inside both the mask and the image (retries up
    to ``max_retries``, then accepts the last candidate, :318-326)."""
    rng = rng or np.random.RandomState(0)
    f = filter_uv(flow, threshold_factor)
    sampled = sample_sam_points(f, n_pos, n_neg, rng)
    if sampled is None:
        return None
    coords, labels = sampled
    mask = np.asarray(segmenter.predict_mask_labeled(image_rgb, coords, labels))
    target = np.argwhere(mask)  # (row, col)
    if len(target) == 0:
        return None
    h, w = mask.shape[:2]
    start = None
    for _ in range(max_retries):
        r, c = target[rng.choice(len(target))]
        start = (int(r), int(c))
        r0, r1 = r - interior, r + interior
        c0, c1 = c - interior, c + interior
        if r0 < 0 or c0 < 0 or r1 >= h or c1 >= w:
            continue  # too close to the image border
        if mask[r0:r1, c0:c1].all():
            return start  # fully interior point
    return start  # the reference gives up looping and keeps the last pick


def chain_trajectory_ref(
    flows: np.ndarray,
    start_rc: Tuple[int, int],
    threshold_factor: float = 0.2,
) -> Optional[List[Tuple[int, int]]]:
    """Reference-exact chaining (generate_traj.py:357-397): mean flow over a
    window around the last point, skipping pixels where EITHER component is
    zero (:386-389 quirk: ``u == 0 or v == 0`` skips); the window starts at
    +-5 and grows by 10 per empty retry.  Discarded (None) when the range
    reaches half the image height (:375-378) OR when >= 1/3 of the frames
    were 'hard to track' (needed an expanded search — :372-373, :427-432:
    the reference rejects such unreliable trajectories).  Appended points
    are int-truncated and NOT clipped to the image."""
    h, _w = flows.shape[1:3]
    traj: List[Tuple[int, int]] = [(int(start_rc[0]), int(start_rc[1]))]
    hard_frames = 0
    for f in flows:
        f = filter_uv(f, threshold_factor)
        ref_r, ref_c = traj[-1]
        lo, hi = -5, 5
        us: List[float] = []
        vs: List[float] = []
        expanded = False
        while not us:
            if lo != -5 and abs(lo) >= h // 2:
                return None  # searched everything, nothing to track
            for i in range(lo, hi):
                for j in range(lo, hi):
                    r, c = ref_r + i, ref_c + j
                    if 0 <= r < f.shape[0] and 0 <= c < f.shape[1]:
                        if f[r, c, 0] == 0 or f[r, c, 1] == 0:
                            continue
                        us.append(float(f[r, c, 0]))
                        vs.append(float(f[r, c, 1]))
            if not us:
                expanded = True  # this frame needed a wider search
            lo -= 10
            hi += 10
        if expanded:
            hard_frames += 1  # one hard_track_idxs entry per FRAME (:372-373)
        traj.append((int(ref_r + sum(vs) / len(vs)), int(ref_c + sum(us) / len(us))))
    if hard_frames >= len(flows) // 3:
        return None  # too unreliable (reference :427-432)
    return traj


def generate_instance_traj(
    input_dir: str,
    num_frames: int = 14,
    flow_fn: FlowFn = farneback_flow,
    segmenter=None,
    rng: Optional[np.random.RandomState] = None,
    threshold_factor: float = 0.2,
) -> Tuple[bool, str]:
    """One instance folder (im_0.jpg..) -> traj_data.txt.  With a segmenter,
    the start point comes from the reference SAM stage; without one, from
    the most-centered moving pixel (documented fallback)."""
    frames = []
    for i in range(num_frames):
        p = os.path.join(input_dir, f"im_{i}.jpg")
        if not os.path.exists(p):
            return False, "Missing frames"
        frames.append(read_image(p))
    flows = compute_flows(np.stack(frames), flow_fn)

    if segmenter is not None:
        start = pick_start_point_sam(
            frames[0], flows[0], segmenter, rng, threshold_factor=threshold_factor
        )
        if start is None:
            return False, "Too few moving points for SAM"
    else:
        start = pick_start_point(flows[0], threshold_factor)
        if start is None:
            return False, "No moving pixels"

    traj = chain_trajectory_ref(flows, start, threshold_factor)
    if traj is None:
        return False, "Lost track (searched all space)"
    write_traj(input_dir, traj)
    return True, "Success!"


def process_dataset_traj(
    input_root: str,
    num_frames: int = 14,
    flow_fn: FlowFn = farneback_flow,
    segmenter=None,
    num_workers: int = 1,
    seed: int = 0,
) -> dict:
    """Batch run over a flat dataset root with soft-failure accounting
    (reference generate_traj.py:583-597 multiprocessing scaffold — realised
    here with a thread pool; the flow backends release the GIL or are
    plain numpy).  The segmenter is stateful (set_image then predict — two
    calls that must not interleave across instances), so a shared one is
    serialised behind a lock; flow dominates the runtime, so worker threads
    still overlap."""
    dirs = [os.path.join(input_root, d) for d in sorted(os.listdir(input_root))
            if os.path.isdir(os.path.join(input_root, d))]
    messages: dict = {}

    if segmenter is not None and num_workers > 1:
        import threading

        class _LockedSegmenter:
            def __init__(self, seg):
                self._seg, self._lock = seg, threading.Lock()

            def predict_mask_labeled(self, *a, **k):
                with self._lock:
                    return self._seg.predict_mask_labeled(*a, **k)

        segmenter = _LockedSegmenter(segmenter)

    def run(args):
        i, d = args
        return generate_instance_traj(
            d, num_frames, flow_fn, segmenter, np.random.RandomState(seed + i)
        )

    if num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_workers) as ex:
            results = list(ex.map(run, enumerate(dirs)))
    else:
        results = [run(x) for x in enumerate(dirs)]
    for _ok, msg in results:
        messages[msg] = messages.get(msg, 0) + 1
    return messages


def write_traj(path: str, traj: List[Tuple[float, float]]) -> None:
    with open(os.path.join(path, "traj_data.txt"), "w") as f:
        for i, (r, c) in enumerate(traj):
            f.write(f"{i} {c} {r}\n")  # frame x y (same order as data.txt)


def per_video_motion(frames_rgb: np.ndarray, flow_fn: FlowFn = farneback_flow) -> float:
    """Mean flow magnitude across the clip (motion_stats.py:62-66)."""
    flows = compute_flows(frames_rgb, flow_fn)
    return float(np.mean(np.sqrt(flows[..., 0] ** 2 + flows[..., 1] ** 2)))


def dataset_motion_stats(videos: List[np.ndarray], flow_fn: FlowFn = farneback_flow):
    vals = np.array([per_video_motion(v, flow_fn) for v in videos])
    return {"mean": float(vals.mean()), "std": float(vals.std()),
            "values": vals.tolist()}


def main(argv=None):
    """Batch CLI (reference generate_traj.py:552-600):
    ``python -m this_and_that_vdm_tpu_torch.curation.trajectory IN
    [--workers N] [--raft ckpt | --native-flowformer npz] [--sam ckpt] [--device cpu]``.  The models run
    on the card unless ``--device cpu``; without a flow checkpoint, cv2's
    Farneback flow is used."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="Flow trajectories over a dataset root")
    p.add_argument("input_root")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--frames", type=int, default=14)
    p.add_argument("--flowformer", default=None,
                   help="FlowFormer checkpoint (vendored flowformer_code)")
    p.add_argument("--raft", default=None,
                   help="RAFT checkpoint (e.g. raft-things.pth) for the port's flow network "
                        "(models/raft.py)")
    p.add_argument("--native-flowformer", default=None,
                   help="FlowFormer parameters as a flowformer_params_save .npz for the port's "
                        "flow network (models/flowformer.py)")
    p.add_argument("--sam", default=None, help="segment-anything checkpoint")
    p.add_argument("--sam-type", default="vit_h")
    p.add_argument("--sam-backend", default="native", choices=("native", "torch"),
                   help="native = the port's SAM (models/sam.py); torch = external "
                        "segment-anything package")
    p.add_argument("--device", default="cuda",
                   help="device of the models (default: the CUDA card; cpu)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    flow_fn = farneback_flow
    if args.raft:
        from .detectors import NativeRAFTFlow

        flow_fn = NativeRAFTFlow(args.raft, device=args.device)
    elif args.native_flowformer:
        from .detectors import NativeFlowFormerFlow

        flow_fn = NativeFlowFormerFlow(args.native_flowformer, device=args.device)
    elif args.flowformer:
        from .detectors import FlowFormerFlow

        flow_fn = FlowFormerFlow(args.flowformer, device=args.device)
    segmenter = None
    if args.sam and args.sam_backend == "native":
        from .detectors import NativeSAMSegmenter

        segmenter = NativeSAMSegmenter(args.sam, args.sam_type, device=args.device)
    elif args.sam:
        from .detectors import SAMSegmenter

        segmenter = SAMSegmenter(args.sam, args.sam_type, device=args.device)
    messages = process_dataset_traj(
        args.input_root, num_frames=args.frames, flow_fn=flow_fn,
        segmenter=segmenter, num_workers=args.workers, seed=args.seed,
    )
    print(json.dumps(messages, indent=2))
    return messages


if __name__ == "__main__":
    main()
