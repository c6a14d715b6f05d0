"""The port's multi-card paths on one host of four CUDA cards.

    python3 mesh_multichip.py

1. kernels    K1-K4 on every card, from a thread whose current device is
              card 0 (so each launch switches to the tensors' card): the
              first bf16 and fp32 case of each kernel in chip_smoke.py,
              against its plain version at chip_smoke's bounds.  A launcher
              that kept its per-process state of the first card (a
              shared-memory attribute, the occupancy wave) or took another
              card's stream fails here.
2. train      train_loop on config/train_image2video_gesturenet.yaml (full
              width, synthetic clips), 3 steps: one process at
              train_batch_size 4, then --devices 4 --fsdp 2 (dp 2 x fsdp 2,
              NCCL) and --devices 4 --fsdp 4 at 1 clip a rank: the same
              global batch.  Loss and global gradient norm held to
              chip_smoke.MESH_TRAIN_REL_BOUND; seconds per step, and each
              rank's trainable parameter bytes at rest (ZeRO-3: at most
              1/fsdp of the model plus a padding block a leaf), peak memory
              and synchronised step seconds (train_loop's ranks.json).
3. serve      VideoGenServer of the full-width VGL pipeline (bf16): two
              4-step requests served unsplit on card 0, then as one batch on
              make_serving_mesh(cards 0-3, cfg=2) (clip 2 x cfg 2: each clip
              on its own pair of cards, its CFG branches apart); final
              latents held to chip_smoke.MESH_SERVE_REL_L2_BOUND; latency of
              each.

Needs four cards.  Prints one line a check, the cards' names and power
limits, and writes chiprun_out/mesh_multichip.json.
Arguments name the phases to run (default: all three), e.g.
``python3 mesh_multichip.py train``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as c  # noqa: E402

CARDS = 4


def phase_kernels(smi):
    """The first bf16 and fp32 case of each kernel on every card, launched
    from card 0's thread state (the main thread, then a worker thread)."""
    out = []
    for dev in range(CARDS):
        with torch.cuda.device(dev):
            cases = c.kernel_cases() + c.adam8bit_cases()
        seen, picked = set(), []
        for case in cases:
            key = (case["kernel"], " bf16" in case["label"], "tree" in case)
            if key not in seen:
                seen.add(key)
                picked.append(case)
        torch.cuda.set_device(0)
        for where in ("main thread", "worker thread"):
            for case in picked:
                res = {}

                def run(case=case, res=res):
                    torch.cuda.set_device(0)
                    res["got"], res["want"] = case["kern"](), case["plain"]()
                    torch.cuda.synchronize(dev)

                if where == "main thread":
                    run()
                else:
                    t = threading.Thread(target=run)
                    t.start()
                    t.join()
                got, want = res["got"], res["want"]
                if case["kernel"] == "adam8bit":
                    if "tree" in case:
                        _, rel, _ = c.k4_tree_compare(got, want, case["tree"])
                    else:
                        _, rel, _ = c.k4_compare(got, want)
                    ok, on = True, got[0][0].device if "tree" in case else got[0].device
                else:
                    _, rel = c.rel_err(got, want, case["scale"])
                    ok, on = rel < c.BOUND[got.dtype], got.device
                out.append(dict(card=dev, where=where, kernel=case["kernel"], case=case["label"],
                                rel_err=rel, ok=ok, device=str(on)))
                c.log(f"[kernels] card {dev} ({where}, current device cuda:0): "
                      f"{case['kernel']} {case['label']} on {on}: rel {rel:.3e} "
                      f"{'ok' if ok else 'FAILED'}")
                if not ok or on != torch.device("cuda", dev):
                    raise RuntimeError(f"kernels: {out[-1]}")
        del cases, picked
        torch.cuda.empty_cache()
    c.log(f"[kernels] every case on every card within its bound  [{smi}]")
    return out


def _train(cfg_path, out_dir, argv, rec):
    from this_and_that_vdm_tpu_torch.training import train_loop

    def on_step(step, state, m, models):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if step == 0:
            torch.cuda.reset_peak_memory_stats()
        else:
            rec["metrics"].append(dict(step=step, loss=float(m["loss"]),
                                       grad_norm=float(m["grad_norm"])))
            rec["step_s"].append(now - rec["t"])
        rec["t"] = time.perf_counter()

    t0 = time.perf_counter()
    train_loop.main(["--config", cfg_path, "--mode", "vgl", "--max-steps", "3",
                     "--synthetic", "8"] + argv, on_step=on_step)
    rec["wall_s"] = time.perf_counter() - t0
    rec["peak_bytes_rank0"] = torch.cuda.max_memory_allocated(0)
    with open(os.path.join(out_dir, "ranks.json")) as f:
        rec["ranks"] = json.load(f)


def phase_train(smi):
    _, config, _, _ = c.TRAIN_CONFIGS[0]
    tmp = tempfile.mkdtemp(prefix="mesh_multichip_")
    runs = {}
    try:
        for name, batch, fsdp in (("one process, batch 4", 4, None),
                                  ("4 ranks (dp 2 x fsdp 2), batch 1 a rank", 1, 2),
                                  ("4 ranks (fsdp 4), batch 1 a rank", 1, CARDS)):
            argv = [] if fsdp is None else ["--devices", str(CARDS), "--fsdp", str(fsdp)]
            edits = {"output_dir": f"{tmp}/{len(runs)}", "train_batch_size": batch}
            with open(config) as f:
                lines = [next((f"{k}: {v}" for k, v in edits.items()
                               if line.startswith(f"{k}:")), line)
                         for line in f.read().splitlines()]
            cfg_path = os.path.join(tmp, f"{len(runs)}.yaml")
            with open(cfg_path, "w") as f:
                f.write("\n".join(lines) + "\n")
            rec = dict(metrics=[], step_s=[], fsdp=fsdp)
            _train(cfg_path, edits["output_dir"], argv, rec)
            runs[name] = rec
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = runs["one process, batch 4"]
    for k, r in runs.items():
        c.log(f"[train] {k}: metrics {r['metrics']}; seconds per step "
              f"{[round(t, 4) for t in r['step_s']]}; rank 0 peak memory "
              f"{r['peak_bytes_rank0'] / 2**30:.2f} GiB; wall {r['wall_s']:.1f} s  [{smi}]")
        for q in r["ranks"]:
            c.log(f"[train] {k}: rank {q['rank']}: trainable parameters at rest "
                  f"{q['resident_param_bytes'] / 2**30:.3f} of {q['whole_param_bytes'] / 2**30:.3f}"
                  f" GiB, peak {q['peak_bytes'] / 2**30:.2f} GiB, seconds per step "
                  f"{[round(t, 4) for t in q['step_s']]}  [{smi}]")
    bad = []
    for k, r in runs.items():
        if r is ref:
            continue
        r["rel"] = [max(abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                        abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
                    for a, b in zip(r["metrics"], ref["metrics"])]
        c.log(f"[train] {k} against one process at the same global batch: worst relative "
              f"difference of loss / gradient norm by step {[f'{x:.3e}' for x in r['rel']]} "
              f"(bound {c.MESH_TRAIN_REL_BOUND:.0e})")
        if len(r["rel"]) != 3 or max(r["rel"]) > c.MESH_TRAIN_REL_BOUND:
            bad.append(k)
        for q in r["ranks"]:  # ZeRO-3: a rank's share of the model, one padding block a leaf
            whole = q["whole_param_bytes"]
            if q["resident_param_bytes"] > whole / r["fsdp"] + q["leaves"] * 256 * 4:
                bad.append(f"{k}: rank {q['rank']} holds {q['resident_param_bytes']} bytes")
    if bad:
        raise RuntimeError(f"train: {bad}: {runs}")
    return dict(runs=runs)


@torch.no_grad()
def phase_serve(smi):
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.parallel import make_serving_mesh
    from this_and_that_vdm_tpu_torch.pipelines import StableVideoDiffusionControlNetPipeline
    from this_and_that_vdm_tpu_torch.serving import VideoGenServer

    torch.cuda.set_device(0)
    base = c.build_pipeline()
    mods = dict(unet=base.unet, vae=base.vae, image_encoder=base.image_encoder,
                controlnet=base.controlnet, text_encoder=base.text_encoder)
    reqs = []
    for seed, points in zip(c.MESH["seeds"], c.MESH["points"]):
        image, ids, _ = c.request_inputs(seed)
        reqs.append((image[0].cpu().numpy(), c.gesture_raster(points, seed),
                     ids[0].cpu().numpy(), seed))
    common = dict(num_frames=c.F, num_inference_steps=c.MESH["steps"],
                  decode_chunk_size=c.DECODE_CHUNK, output_type="uint8")

    def serve(mesh, together):
        shared, traces = {}, [{} for _ in reqs]
        kw = dict(max_delay_s=5.0, trace=shared) if together else {}
        with VideoGenServer(StableVideoDiffusionControlNetPipeline(**mods), mesh=mesh, **common,
                            **kw) as server:
            t0 = time.perf_counter()
            if together:
                futs = [server.submit(i, condition=cd, prompt_ids=ids, seed=s)
                        for i, cd, ids, s in reqs]
                [f.result(timeout=900) for f in futs]
                lat = [shared["latents"][j:j + 1].float().cpu() for j in range(len(reqs))]
                times = [time.perf_counter() - t0]
                batches = [f.timing["batch"] for f in futs]
            else:
                lat, times, batches = [], [], []
                for (i, cd, ids, s), tr in zip(reqs, traces):
                    f = server.submit(i, condition=cd, prompt_ids=ids, seed=s, trace=tr)
                    f.result(timeout=900)
                    lat.append(tr["latents"].float().cpu())
                    times.append(time.perf_counter() - t0)
                    batches.append(f.timing["batch"])
                    t0 = time.perf_counter()
        return lat, times, batches

    alone, alone_s, _ = serve(None, False)
    serve(make_serving_mesh([torch.device("cuda", d) for d in range(CARDS)], cfg=2), True)
    ops.reset_launch_counts()
    mesh = make_serving_mesh([torch.device("cuda", d) for d in range(CARDS)], cfg=2)
    split, split_s, batches = serve(mesh, True)
    counts = ops.launch_counts()
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(split, alone)]
    rep = dict(mesh=mesh.shape, rel_l2=rel, bound=c.MESH_SERVE_REL_L2_BOUND,
               unsplit_each_s=alone_s, mesh_batch_s=split_s, batches=batches, launches=counts)
    c.log(f"[serve] clip 2 x cfg 2 over cuda:0-3, a batch of the two 4-step requests in "
          f"{split_s[0]:.3f} s (second run; batch sizes {batches}); unsplit on cuda:0 one at a "
          f"time {[round(t, 3) for t in alone_s]} s; final latents rel L2 against unsplit "
          f"{[f'{x:.3e}' for x in rel]} (bound {c.MESH_SERVE_REL_L2_BOUND:.0e}); launches "
          f"{counts}  [{smi}]")
    if max(rel) > c.MESH_SERVE_REL_L2_BOUND or batches != [2, 2]:
        raise RuntimeError(f"serve: {rep}")
    if min(counts[k] for k in c.INFERENCE_KERNELS) == 0:
        raise RuntimeError(f"serve: the path skipped a kernel: {counts}")
    return rep


def main():
    t0 = time.perf_counter()
    smi = c.phase_device()
    if torch.cuda.device_count() < CARDS:
        raise RuntimeError(f"mesh_multichip needs {CARDS} cards, found "
                           f"{torch.cuda.device_count()}")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip().splitlines()
    c.log(f"cards: {cards}")
    c.phase_build()
    phases = dict(kernels=phase_kernels, train=phase_train, serve=phase_serve)
    wanted = sys.argv[1:] or list(phases)
    if set(wanted) - set(phases):
        raise SystemExit(f"mesh_multichip: phases are {list(phases)}, got {wanted}")
    rep = dict(card=smi, cards=cards)
    for name in wanted:
        rep[name] = phases[name](smi)
    rep["wall_s"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "mesh_multichip.json"), "w") as f:
        json.dump(rep, f, indent=1, default=str)
    c.log(f"[done] wall {rep['wall_s']:.1f} s")
    c.log(smi)
    print(json.dumps({"ok": True, "cards": torch.cuda.device_count()}), flush=True)


if __name__ == "__main__":
    main()
