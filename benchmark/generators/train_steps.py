"""Train steps of the program's VL finetune, back to back.

Traffic parameters (``traffic/<name>.json``): ``loader_workers`` threads of
the program's ``data.bridge.PrefetchLoader`` over a data set of the
benchmark's, ``dataset_clips`` seeded clips in it, and ``check_steps``, the
first steps that the reference follows.

The configuration's ``train`` block holds the values of the shipped YAML
that the program's ``train_loop.train_config_from_yaml`` reads.  Set-up
builds the program's models from seeded weights (the trainable UNet in
fp32 with ``remat`` as ``gradient_checkpointing`` says, the frozen towers
cast to the ``mixed_precision`` dtype by the program's
``cast_compute_dtype``), its optimizer (``trainer.make_optimizer``), state
and step (``trainer.make_vl_train_step``); then it drives that step object
through its first ``check_steps`` steps, which warm every shape, and hands
the same object to the window.  Every step takes its batch from the loader
and its random draws (sigma, noise, first-frame noise, dropout) from the
run's seed and the step's index, made on the device by the benchmark.

What is compared: each checked step's loss (the worst step's gap), each
leaf's first gradient as the optimizer holds it after step 1 (its first
moment over 1 - beta1), and each leaf's change over the checked steps
(leaves whose step-1 gradient in the reference is under a thousandth of the
median leaf's are left out); both by the worst leaf's gap, over that leaf's
or the median leaf's norm.  The reference repeats those steps on the same
batches, draws and weights in fp32.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import trace, weights
from benchmark.generators.closed_loop_serve import device_info, port_models, sync
from benchmark.reference import ops as ref_ops
from benchmark.reference import train as ref_train

FROZEN = ("vae", "image_encoder", "text_encoder")


class ClipDataset:
    """Seeded clips: smooth random frames in [-1, 1] drifting over time,
    77 prompt ids and the configuration's motion bucket."""

    def __init__(self, seed: int, n: int, frames: int, h: int, w: int, motion: float):
        self.seed, self.n, self.frames, self.h, self.w = seed, n, frames, h, w
        self.motion = np.float32(motion)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng([self.seed % 2 ** 64, 11, int(idx)])
        f, h, w = self.frames, self.h, self.w
        low = rng.uniform(-1, 1, (1, 3, 2, h // 32 + 1, w // 32 + 1)).astype(np.float32)
        clip = F.interpolate(torch.from_numpy(low), size=(f, h, w), mode="trilinear",
                             align_corners=True)[0].permute(1, 2, 3, 0).numpy()
        clip = np.clip(clip + 0.05 * rng.standard_normal(clip.shape, np.float32), -1, 1)
        ids = np.zeros(77, np.int64)
        n = int(rng.integers(4, 40))
        ids[0], ids[1:n + 1], ids[n + 1] = 49406, rng.integers(0, 49406, n), 49407
        return dict(video_frames=clip, prompt_ids=ids, motion_bucket_id=self.motion)


def draws(seed: int, step: int, frames: int, h: int, w: int, device) -> dict:
    """Step ``step``'s random draws, made on the device from the seed."""
    g = torch.Generator(device=device).manual_seed(weights.derived_seed(seed, 100, step))
    return dict(sigma=torch.randn((1,), generator=g, device=device),
                noise=torch.randn((1, frames, h // 8, w // 8, 4), generator=g, device=device),
                aug=torch.randn((1, h, w, 3), generator=g, device=device),
                dropout=torch.rand((1,), generator=g, device=device))


def first_moment_norms(opt_state, b1: float, numels: dict) -> dict:
    """Each leaf's first gradient as the program's 8-bit state holds it
    after one step: the norm of its first moment over 1 - beta1."""
    adam = opt_state[0]
    return {k: float(ref_train.dequantize(q.q, q.scale, True, numels[k]).norm()) / (1 - b1)
            for k, q in adam.mu.items()}


def _gaps(got: dict, want: dict, keys) -> dict:
    keys = list(keys)
    median = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys}


def leaf_gap(got: dict, want: dict, keys) -> float:
    """Worst leaf's gap between two norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    return max(_gaps(got, want, keys).values())


def median_leaf_gap(got: dict, want: dict, keys) -> float:
    """The median over leaves of the gap between two norms over the
    reference's norm of the leaf."""
    return float(np.median([abs(got[k] - want[k]) / max(want[k], 1e-30) for k in keys]))


def worst_leaf(got: dict, want: dict, keys) -> list:
    """``[leaf, program's norm, reference's norm]`` of the worst gap."""
    gaps = _gaps(got, want, keys)
    k = max(gaps, key=gaps.get)
    return [k, got[k], want[k]]


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    from this_and_that_vdm_tpu_torch.data import bridge
    from this_and_that_vdm_tpu_torch.training import optimizers, train_loop, trainer

    cfg, traffic = cell.config, cell.traffic
    t, b, sizes = cfg["train"], cfg["batch"], cfg["models"]
    f, h, w = b["num_frames"], b["height"], b["width"]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    frozen_dtype = train_loop.frozen_dtype_from_yaml(t)
    modules = port_models({k: sizes[k] for k in FROZEN}, seed, device, frozen_dtype)
    remat = bool(t["gradient_checkpointing"])
    unet = port_models({"unet": dict(sizes["unet"], remat=remat)}, seed, device, None)["unet"]
    unet.float().train().requires_grad_(True)
    p0, _ = weights.draw("unet", sizes["unet"], seed, device)  # the start, for the change
    tcfg = train_loop.train_config_from_yaml(t, cfg["mode"])
    params = dict(unet.named_parameters())
    tx = trainer.make_optimizer(tcfg, params)
    host_ms = []

    def update(updates, state, params=None):
        t0 = time.perf_counter()
        out = tx.update(updates, state, params)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    timed_tx = optimizers.GradientTransformation(tx.init, update)
    state = trainer.init_train_state(unet, timed_tx)
    step_fn = trainer.make_vl_train_step(unet, modules, timed_tx, tcfg)
    dataset = ClipDataset(seed, traffic["dataset_clips"], f, h, w, t["motion_bucket_id"])
    loader = bridge.PrefetchLoader(dataset, b["batch_size"], traffic["loader_workers"],
                                   seed=weights.derived_seed(seed, 12) % 2 ** 31)
    batches = iter(loader)
    waits, done, kept, losses = [], [], [], []

    def one_step(i: int, keep: bool):
        nonlocal state, batches
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:  # a new epoch of the loader
            batches = iter(loader)
            batch = next(batches)
        waits.append(time.perf_counter() - t0)
        if keep:
            kept.append(batch)
        dev_batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
        state, m = step_fn(state, dev_batch, draws=draws(seed, i, f, h, w, device))
        sync(device)
        done.append(time.perf_counter())
        return m

    n_check = traffic["check_steps"]
    numels = {k: p.numel() for k, p in params.items()}
    for i in range(n_check):
        m = one_step(i, True)
        losses.append(float(m["loss"]))
        if i == 0:
            grad_p = first_moment_norms(state.opt_state, t["adam_beta1"], numels)
    with torch.no_grad():
        change_p = {k: float((p.detach() - p0[k]).norm()) for k, p in params.items()}
    del p0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    # the window
    waits.clear(), done.clear(), host_ms.clear()
    prof = trace.Profile() if traced else None
    t_open = time.perf_counter()
    deadline = t_open + seconds
    if prof is not None:
        prof.start()
    i, finite, failed = n_check, True, 0
    while time.perf_counter() < deadline:
        m = one_step(i, False)
        i += 1
        if not torch.isfinite(m["loss"]):
            failed += 1
    if prof is not None:
        prof.stop()
    steps_run = i - n_check
    inside = [x for x in done if x <= deadline]
    window_s = max(inside) - t_open if inside else 0.0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    data_wait, opt_ms = list(waits), list(host_ms)
    batches.close()
    del batches, loader, state, step_fn, tx, timed_tx, unet, modules, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the program is freed
    t_ref = time.perf_counter()
    ref = {name: weights.reference_model(name, sizes[name], seed, device) for name in FROZEN}
    ref["unet"] = weights.reference_model("unet", sizes["unet"], seed, device, remat=remat)
    ref["unet"].train().requires_grad_(True)
    start = {k: p.detach().clone() for k, p in ref["unet"].named_parameters()}
    ref_batches = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in bt.items()}
                   for bt in kept]
    ref_draws = [draws(seed, j, f, h, w, device) for j in range(n_check)]
    with ref_ops.no_tf32():
        losses_r, grad_r, grad_exact, opt = ref_train.vl_steps(ref, t, ref_batches, ref_draws)
    with torch.no_grad():
        change_r = {k: float((p.detach() - start[k]).norm())
                    for k, p in ref["unet"].named_parameters()}
    reference_s = time.perf_counter() - t_ref
    del ref, start, opt

    median_grad = float(np.median(list(grad_exact.values())))
    moving = [k for k, v in grad_exact.items() if v >= 1e-3 * median_grad]
    limits = cfg["limits"]
    compared = {
        "loss_gap": max(abs(a - r) / abs(r) for a, r in zip(losses, losses_r)),
        "grad_norm_gap": leaf_gap(grad_p, grad_r, grad_r),
        "change_gap": leaf_gap(change_p, change_r, moving),
    }
    readings = dict(
        setup_s=setup_s, window_s=window_s, steps=len(inside), steps_traced=steps_run,
        data_wait_s=data_wait, optimizer_host_ms=opt_ms,
        peak_bytes=peak, config=cfg, traffic=traffic, attempted=steps_run, failed=failed,
        correct=failed == 0 and bool(np.isfinite(losses + list(compared.values())).all()),
        compared={k: {"value": float(v), "limit": limits[k]} for k, v in compared.items()},
        device=device_info(device, peak),
        notes=dict(losses=losses, losses_ref=losses_r, reference_s=round(reference_s, 3),
                   leaves_left_out=len(grad_exact) - len(moving), steps_traced=steps_run,
                   worst_grad=worst_leaf(grad_p, grad_r, grad_r),
                   median_change_gap=median_leaf_gap(change_p, change_r, moving),
                   worst_change=worst_leaf(change_p, change_r, moving)))
    if prof is not None:
        summary = prof.summary()
        readings["summary"] = summary
        readings["device"].update(busy_s=summary.busy_s(), window_s=summary.window_s)
        readings["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    return readings
