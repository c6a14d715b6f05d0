"""Acceptance / evaluation CLI: compare two rendered-output trees
(counterpart of ``this_and_that_vdm_tpu/cli/eval.py``).

Point it at two trees of instance folders (each ``<instance>/0.png..N.png``,
the layout ``cli/inference.py`` writes) and it reports per-frame PSNR and
per-instance SSIM, and enforces the PSNR gate with a nonzero exit code on
failure; with LPIPS weights (``utils/lpips.py``: torchvision AlexNet
``features`` + the LPIPS ``lin`` heads) it adds each instance's LPIPS,
computed on ``--device`` (the CUDA card by default).

    python -m this_and_that_vdm_tpu_torch.cli.eval OURS_ROOT REF_ROOT \\
        --psnr-gate 35 --out metrics.json \\
        [--lpips-weights lpips.pth | --lpips-alexnet alexnet.pth --lpips-lin lin.pth]

Either root may also be a single instance folder (contains ``0.png``
directly); both must then be.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..utils import video_io


def _instances(root: str, ext: str) -> Dict[str, str]:
    """Map instance name -> frame dir.  A root holding ``0.png`` itself is a
    single anonymous instance."""
    if os.path.exists(os.path.join(root, f"0{ext}")):
        return {".": root}
    out = {}
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if os.path.isdir(d) and os.path.exists(os.path.join(d, f"0{ext}")):
            out[name] = d
    return out


def _load_lpips(alexnet_path: Optional[str], lin_path: Optional[str],
                combined_path: Optional[str] = None, device="cuda"):
    """The video-LPIPS scorer ``(frames_a, frames_b) -> float`` from torch
    checkpoints, or None without them.  ``combined_path`` is ONE file
    holding ``{"alexnet": <features state>, "lin": <lin heads state>}`` or a
    flat merged state dict (``features.N.*`` and ``lin{i}.model.1.weight``)."""
    if not (combined_path or (alexnet_path and lin_path)):
        return None
    import torch

    from ..utils import lpips as lpips_mod

    if combined_path:
        blob = torch.load(combined_path, map_location="cpu", weights_only=True)
        if "alexnet" in blob and "lin" in blob:
            alex, lin = blob["alexnet"], blob["lin"]
        else:
            alex = {k: v for k, v in blob.items() if k.startswith("features.")}
            lin = {k: v for k, v in blob.items() if k.startswith("lin")}
    else:
        alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
        lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    model = lpips_mod.lpips_model(alex, lin, device)
    return lambda a, b: lpips_mod.video_lpips(model, np.stack(a), np.stack(b))


def evaluate_trees(root_a: str, root_b: str, ext: str = ".png",
                   psnr_gate: Optional[float] = None, lpips_video=None) -> dict:
    """Compare every instance present in both trees; returns the report dict.

    ``gate_pass`` is true iff EVERY frame of EVERY common instance meets
    ``psnr_gate``; absent instances and frame-count mismatches fail the gate
    too (they mean a render is missing).  ``lpips_video`` (from
    ``_load_lpips``) adds ``lpips_mean`` per instance."""
    a_map = _instances(root_a, ext)
    b_map = _instances(root_b, ext)
    common = sorted(set(a_map) & set(b_map))
    report: dict = {
        "root_a": root_a,
        "root_b": root_b,
        "only_a": sorted(set(a_map) - set(b_map)),
        "only_b": sorted(set(b_map) - set(a_map)),
        "instances": {},
    }
    all_psnr: List[float] = []
    all_ssim: List[float] = []
    mismatched = False
    for name in common:
        fa = video_io.load_frames_dir(a_map[name], ext)
        fb = video_io.load_frames_dir(b_map[name], ext)
        n = min(len(fa), len(fb))
        row: dict = {"frames_a": len(fa), "frames_b": len(fb)}
        if len(fa) != len(fb):
            mismatched = True
        if n == 0 or fa[0].shape != fb[0].shape:
            row["error"] = ("no frames" if n == 0 else
                            f"shape mismatch {fa[0].shape} vs {fb[0].shape}")
            mismatched = True
            report["instances"][name] = row
            continue
        m = video_io.per_frame_metrics(fa[:n], fb[:n])
        # identical frames give PSNR = inf; capped at 99 dB so the report
        # stays strict JSON (the gate sees the raw value)
        cap = lambda p: round(min(p, 99.0), 3)  # noqa: E731
        row.update(
            psnr=[cap(p) for p in m["psnr"]],
            ssim=[round(s, 4) for s in m["ssim"]],
            psnr_mean=cap(m["psnr_mean"]),
            psnr_min=cap(min(m["psnr"])),
            ssim_mean=round(m["ssim_mean"], 4),
        )
        if lpips_video is not None:
            row["lpips_mean"] = round(float(lpips_video(fa[:n], fb[:n])), 5)
        all_psnr.extend(m["psnr"])
        all_ssim.extend(m["ssim"])
        report["instances"][name] = row

    report["n_instances"] = len(common)
    if all_psnr:
        report["psnr_mean"] = round(min(float(np.mean(all_psnr)), 99.0), 3)
        report["psnr_min"] = round(min(float(min(all_psnr)), 99.0), 3)
        report["ssim_mean"] = round(float(np.mean(all_ssim)), 4)
    if psnr_gate is not None:
        frames_ok = bool(all_psnr) and all(p >= psnr_gate or math.isinf(p) for p in all_psnr)
        report["psnr_gate"] = psnr_gate
        report["gate_pass"] = (frames_ok and not mismatched
                               and not report["only_a"] and not report["only_b"])
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root_a", help="rendered outputs under test")
    p.add_argument("root_b", help="reference renders")
    p.add_argument("--ext", default=".png")
    p.add_argument("--psnr-gate", type=float, default=None,
                   help="per-frame PSNR acceptance threshold (35 for the reference gate)")
    p.add_argument("--lpips-alexnet", default=None,
                   help="torchvision alexnet state_dict (.pth)")
    p.add_argument("--lpips-lin", default=None, help="LPIPS linear-head state_dict (.pth)")
    p.add_argument("--lpips-weights", default=None,
                   help="ONE torch file with both LPIPS checkpoints: "
                        "{'alexnet':..., 'lin':...} or a flat merged dict")
    p.add_argument("--device", default="cuda",
                   help="torch device of the LPIPS scorer (default: the CUDA card)")
    p.add_argument("--out", default=None, help="write the report JSON here")
    args = p.parse_args(argv)

    lp = _load_lpips(args.lpips_alexnet, args.lpips_lin, args.lpips_weights, args.device)
    report = evaluate_trees(args.root_a, args.root_b, args.ext, args.psnr_gate, lp)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.psnr_gate is not None and not report.get("gate_pass", False):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
