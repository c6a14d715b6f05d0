"""The controls of the check of outputs, run on the card at a cell's own
sizes (not part of a benchmark run):

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

The control is the reference put in the program's place and computed one
precision below the configuration's: fp8 (e4m3, per-tensor scales) for a
bf16 serving configuration; for the VL step, bf16 for the fp32 UNet and fp8
for the frozen towers that the configuration runs in bf16.  For each seed
it prints, as one JSON line, the numbers that a run compares, read off the
control against the fp32 reference on the same inputs and weights, and the
same numbers for the faults planted in the reference's output: a served
clip with one frame altered (inverted) where it is produced; a training
loss altered (times 1.5); a step that leaves the state unchanged reads 1
by the change's measure and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, weights  # noqa: E402
from benchmark.reference import ops as ref_ops  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

LOWER = {"bfloat16": "fp8", "float32": "bf16"}


def serve_control(cell, seed: int, clips: int, device) -> dict:
    gen = harness.load_module(cell.generator)
    s, sizes = cell.config["sampling"], cell.config["models"]
    ref = {n: weights.reference_model(n, sizes[n], seed, device) for n in gen.MODELS}
    lower = LOWER[cell.config["compute_dtype"]]
    out = {"control": 0.0, "bf16": 0.0, "altered": float("inf")}
    for j in range(clips):
        req = gen.request(seed, 0, j, s, cell.traffic)
        want = gen.reference_frames(ref, req, s, device)
        out["control"] = max(out["control"],
                             gen.frame_rmse(gen.reference_frames(ref, req, s, device, lower), want))
        out["bf16"] = max(out["bf16"],
                          gen.frame_rmse(gen.reference_frames(ref, req, s, device, "bf16"), want))
        altered = want.copy()
        altered[-1] = 255 - altered[-1]
        out["altered"] = min(out["altered"], gen.frame_rmse(altered, want))
    return out


def train_control(cell, seed: int, device) -> dict:
    gen = harness.load_module(cell.generator)
    cfg, traffic = cell.config, cell.traffic
    t, b, sizes = cfg["train"], cfg["batch"], cfg["models"]
    f, h, w = b["num_frames"], b["height"], b["width"]
    data = gen.ClipDataset(seed, traffic["dataset_clips"], f, h, w, t["motion_bucket_id"])
    n = traffic["check_steps"]
    batches = [{k: torch.from_numpy(np.asarray(v)[None]).to(device) for k, v in data[i].items()}
               for i in range(n)]
    draws = [gen.draws(seed, i, f, h, w, device) for i in range(n)]
    remat = bool(t["gradient_checkpointing"])
    runs = {}
    # one step below what the configuration states: the fp32 UNet in bf16,
    # the frozen towers (bf16 under mixed_precision) in fp8
    frozen_lower = LOWER["bfloat16" if t["mixed_precision"] in ("bf16", "fp16") else "float32"]
    for precision, frozen in (("fp32", None), ("bf16", frozen_lower)):
        ref = {k: weights.reference_model(k, sizes[k], seed, device) for k in gen.FROZEN}
        ref["unet"] = weights.reference_model("unet", sizes["unet"], seed, device, remat=remat)
        ref["unet"].train().requires_grad_(True)
        start = {k: p.detach().clone() for k, p in ref["unet"].named_parameters()}
        with ref_ops.no_tf32(), ref_ops.precision(precision):
            losses, first, exact, opt = ref_train.vl_steps(ref, t, batches, draws, frozen)
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in ref["unet"].named_parameters()}
        runs[precision] = (losses, first, exact, change)
        del ref, start, opt
        torch.cuda.empty_cache()
    (lr, gr, ex, cr), (lc, gc_, _, cc) = runs["fp32"], runs["bf16"]
    median = float(np.median(list(ex.values())))
    moving = [k for k, v in ex.items() if v >= 1e-3 * median]
    return {"control": {"loss_gap": max(abs(a - r) / abs(r) for a, r in zip(lc, lr)),
                        "grad_norm_gap": gen.leaf_gap(gc_, gr, gr),
                        "change_gap": gen.leaf_gap(cc, cr, moving)},
            "altered": {"loss_gap": 0.5}, "unchanged": {"change_gap": 1.0},
            "losses": lr, "leaves_left_out": len(ex) - len(moving),
            "median_change_gap": gen.median_leaf_gap(cc, cr, moving),
            "worst": {"grad": gen.worst_leaf(gc_, gr, gr), "change": gen.worst_leaf(cc, cr, moving)}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--clips", type=int, default=2, help="served clips a seed")
    args = p.parse_args(argv)
    harness.set_cache_dirs(harness.HERE.parent)
    cell = harness.Cell(args.workload, harness.HERE.parent)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train_steps":
            out = train_control(cell, seed, device)
        else:
            out = serve_control(cell, seed, args.clips, device)
        out.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
