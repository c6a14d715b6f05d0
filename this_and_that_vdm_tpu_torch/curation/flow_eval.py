"""Quantify the flow-backend substitution (counterpart of
``curation/flow_eval.py``).

The reference's trajectory generator (scripts/generate_traj.py:20-26)
requires the USER to vendor FlowFormer; it ships no flow code of its own.
This repo substitutes a native RAFT (models/raft.py) or the cv2 Farneback
fallback (curation/detectors.py).  This module makes that substitution
*quantitative* instead of asserted:

1. **Known-motion clips from real fixture pixels** — a patch of a real
   Bridge_example frame translated at constant velocity over a static real
   background.  Ground-truth trajectory endpoints are exact, so any flow
   backend's *trajectory-level* error (what curation actually consumes —
   endpoints feed rasterize.py; per-frame flow never leaves this stage) is
   directly measurable.
2. **EPE-noise sensitivity of the chain** — chain_trajectory run on
   ground-truth flows corrupted with per-pixel Gaussian noise of a given
   end-point-error (EPE) magnitude.  Published EPE gaps between RAFT and
   FlowFormer are fractions of a pixel (Sintel-clean: RAFT ~1.4 vs
   FlowFormer ~0.9); this measures how much endpoint drift an EPE delta of
   that size can induce AT ALL, bounding the substitution's effect on the
   curated trajectories.
3. **Motion-statistics sensitivity** — dataset_motion_mean/std
   (per_video_motion) under the same noise, since those two scalars are the
   only other thing flow feeds (the motion-bucket mapper,
   data/bridge.py).

The background is an input: the reference's Bridge fixtures are not in the
repository, so callers pass any real or synthetic frame.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import trajectory


def make_moving_patch_clip(
    background_rgb: np.ndarray,
    n_frames: int = 12,
    velocity: Tuple[float, float] = (4.0, 2.0),
    patch_size: int = 48,
    start_rc: Tuple[int, int] = (40, 40),
    patch_from: Tuple[int, int] = (0, 0),
) -> Tuple[np.ndarray, np.ndarray, List[Tuple[float, float]]]:
    """Real-pixel clip with exact ground truth.

    A ``patch_size`` square cut from ``background_rgb`` at ``patch_from``
    is pasted onto the (static) background, translating by ``velocity``
    = (vx, vy) pixels/frame.  Returns (frames [F,H,W,3] uint8,
    gt_flows [F-1,H,W,2] float32, gt_traj [(row, col)] length F) where
    gt_flows is nonzero exactly on the moving patch (the object-motion
    field the reference's gripper clips induce).
    """
    h, w = background_rgb.shape[:2]
    vx, vy = velocity
    ps = patch_size
    py, px = patch_from
    patch = background_rgb[py:py + ps, px:px + ps].copy()
    # make the patch contrast against its destination so flow is observable
    patch = (255 - patch.astype(np.int32)).astype(np.uint8)

    frames, gt_flows = [], []
    r0, c0 = start_rc
    centers = []
    for i in range(n_frames):
        top = int(round(r0 + i * vy))
        left = int(round(c0 + i * vx))
        img = background_rgb.copy()
        img[top:top + ps, left:left + ps] = patch
        frames.append(img)
        centers.append((top + ps / 2.0, left + ps / 2.0))
        if i + 1 < n_frames:
            fl = np.zeros((h, w, 2), np.float32)
            fl[top:top + ps, left:left + ps, 0] = vx
            fl[top:top + ps, left:left + ps, 1] = vy
            gt_flows.append(fl)
    return np.stack(frames), np.stack(gt_flows), centers


def endpoint_error(traj: List[Tuple[float, float]],
                   gt_traj: List[Tuple[float, float]]) -> float:
    """Euclidean distance between final trajectory points (pixels)."""
    (r, c), (gr, gc) = traj[-1], gt_traj[-1]
    return float(np.hypot(r - gr, c - gc))


def gt_endpoint_from(start: Tuple[float, float], n_frames: int,
                     velocity: Tuple[float, float]) -> Tuple[float, float]:
    """Where a point riding the patch from ``start`` ends after F frames.

    Any point ON the moving patch translates rigidly, so ground truth for a
    chain started anywhere on the patch is start + (F-1)*v — this is what a
    backend's endpoint must be compared against (comparing against the
    patch-center path would bake the arbitrary start-point offset into the
    error)."""
    vx, vy = velocity
    return (start[0] + (n_frames - 1) * vy, start[1] + (n_frames - 1) * vx)


def noisy_flows(gt_flows: np.ndarray, epe: float,
                rng: np.random.RandomState) -> np.ndarray:
    """Corrupt ground-truth flows with isotropic Gaussian noise whose mean
    per-pixel endpoint error equals ``epe`` (EPE of 2-D N(0, s^2 I) is
    s*sqrt(pi/2))."""
    s = epe / np.sqrt(np.pi / 2.0)
    return gt_flows + rng.randn(*gt_flows.shape).astype(np.float32) * s


def backend_trajectory(frames: np.ndarray, flow_fn,
                       gt_traj=None) -> List[Tuple[float, float]]:
    """The exact curation chain: flows -> start point -> chained trajectory
    (generate_traj.py pipeline order)."""
    flows = trajectory.compute_flows(frames, flow_fn)
    start = trajectory.pick_start_point(flows[0])
    if start is None and gt_traj is not None:
        start = (int(gt_traj[0][0]), int(gt_traj[0][1]))
    return trajectory.chain_trajectory(flows, start)


def evaluate_backend_on_clip(frames, gt_flows, velocity, flow_fn) -> Dict:
    """Endpoint error + motion-stat delta for one flow backend on one clip.

    Each chain's error is measured against the rigid-translation ground
    truth FROM ITS OWN START POINT (gt_endpoint_from)."""
    n = len(frames)
    traj = backend_trajectory(frames, flow_fn)
    motion = trajectory.per_video_motion(frames, flow_fn)

    # ground-truth chain (what a perfect flow backend would give the SAME
    # chaining code) — isolates backend error from chaining behavior
    start = trajectory.pick_start_point(gt_flows[0])
    gt_chain = trajectory.chain_trajectory(gt_flows, start)
    gt_motion = float(np.mean([np.sqrt((f ** 2).sum(-1)).mean()
                               for f in gt_flows]))
    vx, vy = velocity
    return dict(
        endpoint_err_px=endpoint_error(
            traj, [gt_endpoint_from(traj[0], n, velocity)]),
        chain_endpoint_err_px=endpoint_error(
            gt_chain, [gt_endpoint_from(gt_chain[0], n, velocity)]),
        travel_px=float(np.hypot((n - 1) * vx, (n - 1) * vy)),
        motion_stat=motion,
        gt_motion_stat=gt_motion,
    )


def epe_sensitivity(gt_flows, epes=(0.5, 1.0, 2.0),
                    seeds=(0, 1, 2)) -> List[Dict]:
    """Endpoint drift induced by flow noise of a given EPE — the bound on
    what a RAFT-vs-FlowFormer EPE delta can do to a curated trajectory."""
    start = trajectory.pick_start_point(gt_flows[0])
    clean = trajectory.chain_trajectory(gt_flows, start)
    out = []
    for epe in epes:
        errs, motions = [], []
        for seed in seeds:
            nf = noisy_flows(gt_flows, epe, np.random.RandomState(seed))
            traj = trajectory.chain_trajectory(nf, start)
            errs.append(endpoint_error(traj, clean))
            motions.append(float(np.mean(
                [np.sqrt((f ** 2).sum(-1)).mean() for f in nf])))
        out.append(dict(
            epe=epe,
            endpoint_drift_px_mean=float(np.mean(errs)),
            endpoint_drift_px_max=float(np.max(errs)),
            motion_stat_mean=float(np.mean(motions)),
        ))
    return out
