"""Drive the PyTorch port's VGL clip once on one CUDA card, with its kernels.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. device      a CUDA card must be present; prints its name and power
                 limit; TF32 is turned off for matmuls and cuDNN convolutions
                 (the comparisons below are against full-precision plain math)
  2. build       nvcc builds the Hopper kernels from csrc/ into build/
  3. kernels     each kernel against its plain PyTorch version on the card, at
                 the slice's shapes, in bf16 and fp32, with its time beside the
                 plain version's
  4. denoiser    one full-width ControlNet + UNet forward (CFG batch 2, 14
                 frames of 32x48 latents, bf16) with the kernels and through
                 the plain versions; relative L2 error held to a bound
  5. slice       StableVideoDiffusionControlNetPipeline at full width (seeded
                 random weights, bf16) answers two VGL requests (14 frames of
                 256x384, 1-point and 2-point gesture rasters); the launch
                 counters show every kernel ran on that path

Prints, before the last line, one JSON line with each kernel's launches,
error and times, and the card's name and power limit from nvidia-smi; the
last line is {"ok": true, "device": {...}}.  A longer report goes to
chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Bounds.  fp32: 1e-4 relative (max abs error / max abs reference); the
# kernels keep fp32 products in fp32.  bf16: 2e-2 relative, the rounding of
# the bf16 probability / normalised tensor each kernel rounds (one bf16 ulp
# is 2^-8 = 3.9e-3 relative) plus accumulation-order differences.
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The constant-input GroupNorm case normalises a zero-variance group: the
# output (= beta) is the difference of x*w and mean*w with w = gamma /
# sqrt(eps) ~ 1e3, so its error is measured against |mean * w|, the size of
# the terms that cancel, with the same bounds.
# The full-width denoiser in bf16: ~60 sequential blocks, each rounding its
# activations to bf16 in different places on the two paths.
DENOISER_REL_L2_BOUND = 5e-2

F, H, W = 14, 256, 384  # frames, pixels
STEPS = (25, 25)  # denoise steps of request 1 and 2
DECODE_CHUNK = 8

KERNEL_INFO = {
    "flash_attention": ("this_and_that_vdm_tpu_torch/csrc/flash_attention.cu",
                        "this_and_that_vdm_tpu/ops/flash_attention.py:58"),
    "groupnorm": ("this_and_that_vdm_tpu_torch/csrc/groupnorm.cu",
                  "this_and_that_vdm_tpu/ops/groupnorm_pallas.py:43"),
    "ln_matmul": ("this_and_that_vdm_tpu_torch/csrc/ln_matmul.cu",
                  "this_and_that_vdm_tpu/ops/ln_matmul.py:74"),
}


def log(*args):
    print(*args, flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def rel_err(got, want, scale=None):
    d = (got.float() - want.float()).abs().max().item()
    return d, d / (scale or max(want.float().abs().max().item(), 1e-30))


# ----------------------------------------------------------------- phase 1

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


# ----------------------------------------------------------------- phase 2

def phase_build():
    from this_and_that_vdm_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.library()
    log(f"[build] kernels built/loaded in {time.perf_counter() - t0:.2f} s "
        f"({_native.library_path()})")


# ----------------------------------------------------------------- phase 3

def _randn(shape, dtype, seed, scale=1.0, shift=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)


def kernel_cases():
    """(kernel, label, kernel call, plain call, error scale or None) at the
    slice's shapes; the error is relative to the scale, else to max |plain|."""
    from this_and_that_vdm_tpu_torch.ops import flash_attention as fa
    from this_and_that_vdm_tpu_torch.ops import groupnorm as gn
    from this_and_that_vdm_tpu_torch.ops import ln_matmul as lm

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "fp32"
        for shape in ((28, 1536, 5, 64), (28, 384, 10, 64), (4, 1000, 5, 64)):
            q, k, v = (_randn(shape, dtype, s) for s in range(3))
            cases.append(("flash_attention", f"{list(shape)} {dn}",
                          lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, 0.125),
                          lambda q=q, k=k, v=v: fa._plain(q, k, v, 0.125), None))
        for shape, eps, silu, const in (((28, 1536, 320), 1e-6, True, False),
                                        ((2, 14 * 1536, 320), 1e-5, True, False),
                                        ((8, 256 * 384, 128), 1e-6, False, False),
                                        ((28, 1536, 320), 1e-6, False, True)):
            c = shape[-1]
            x = (torch.full(shape, 3.0, device="cuda", dtype=dtype) if const
                 else _randn(shape, dtype, 4, 2.0, 0.5))
            w, b = _randn((c,), torch.float32, 5, 0.1, 1.0), _randn((c,), torch.float32, 6, 0.1)
            label = f"{list(shape)} eps={eps} silu={silu}{' constant' if const else ''} {dn}"
            cases.append(("groupnorm", label,
                          lambda x=x, w=w, b=b, e=eps, s=silu: gn.group_norm(x, w, b, 32, e, s),
                          lambda x=x, w=w, b=b, e=eps, s=silu: gn._plain(x, w, b, 32, e, s),
                          3.0 * w.abs().max().item() / eps ** 0.5 if const else None))
        for r, c, n, bias in ((43008, 320, 960, False), (43008, 320, 2560, True),
                              (2688, 1280, 10240, True)):
            x = _randn((r, c), dtype, 7)
            s, b = _randn((c,), torch.float32, 8, 0.1, 1.0), _randn((c,), torch.float32, 9, 0.1)
            w = _randn((n, c), dtype, 10, c ** -0.5)
            wb = _randn((n,), torch.float32, 11, 0.1) if bias else None
            cases.append(("ln_matmul", f"R={r} C={c} N={n} bias={bias} {dn}",
                          lambda x=x, s=s, b=b, w=w, wb=wb: lm.ln_matmul(x, s, b, w, wb),
                          lambda x=x, s=s, b=b, w=w, wb=wb: lm._reference(x, s, b, w, wb,
                                                                          1e-5), None))
    return cases


def phase_kernels():
    results = {name: {"max_abs_err": 0.0, "cases": []} for name in KERNEL_INFO}
    for name, label, kern, plain, scale in kernel_cases():
        got = kern()
        want = plain()
        sync()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{name} {label}: non-finite output")
        abs_err, rel = rel_err(got, want, scale)
        bound = BOUND[got.dtype]
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"[kernel] {name:15s} {label:45s} max_abs={abs_err:.3e} rel={rel:.3e} "
            f"(bound {bound:.0e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        if not rel < bound:
            raise RuntimeError(f"{name} {label}: relative error {rel:.3e} >= {bound:.0e}")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["cases"].append(dict(case=label, max_abs_err=abs_err, rel_err=rel, ms=ms,
                               plain_ms=plain_ms))
        if "ms" not in r:  # first case = the main-path site in bf16
            r["ms"], r["plain_ms"] = ms, plain_ms
        del got, want
    sync()
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------- phase 4/5

def build_pipeline():
    from this_and_that_vdm_tpu_torch.models import cast_compute_dtype, init_weights
    from this_and_that_vdm_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                                         CLIPVisionConfig,
                                                         CLIPVisionModelWithProjection)
    from this_and_that_vdm_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel
    from this_and_that_vdm_tpu_torch.models.unet import (UNetConfig,
                                                         UNetSpatioTemporalConditionModel)
    from this_and_that_vdm_tpu_torch.models.vae import (AutoencoderKLTemporalDecoder,
                                                        VAEConfig)
    from this_and_that_vdm_tpu_torch.pipelines import StableVideoDiffusionControlNetPipeline

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    with torch.device("cuda"):
        mods = dict(unet=UNetSpatioTemporalConditionModel(UNetConfig()),
                    vae=AutoencoderKLTemporalDecoder(VAEConfig()),
                    image_encoder=CLIPVisionModelWithProjection(CLIPVisionConfig()),
                    controlnet=ControlNetModel(ControlNetConfig()),
                    text_encoder=CLIPTextModel(CLIPTextConfig()))
    for m in mods.values():
        cast_compute_dtype(init_weights(m, gen), torch.bfloat16).eval().requires_grad_(False)
    sync()
    counts = {k: sum(p.numel() for p in m.parameters()) for k, m in mods.items()}
    log(f"[slice] built full-width models in {time.perf_counter() - t0:.1f} s; params "
        + ", ".join(f"{k}={v / 1e9:.3f}B" for k, v in counts.items()))
    return StableVideoDiffusionControlNetPipeline(**mods)


@contextlib.contextmanager
def plain_versions():
    """Test-only: route the model code's kernel call sites to the plain
    PyTorch versions (the package itself never does this on a CUDA tensor)."""
    from this_and_that_vdm_tpu_torch.models import layers, transformer
    from this_and_that_vdm_tpu_torch.ops import flash_attention as fa
    from this_and_that_vdm_tpu_torch.ops import groupnorm as gn
    from this_and_that_vdm_tpu_torch.ops import ln_matmul as lm

    def ln_plain(x, scale, bias, w, wb=None, eps=1e-5):
        return lm._reference(x, scale, bias, w, wb, eps)

    patches = [(fa, "flash_attention", fa._plain), (layers, "group_norm", gn._plain),
               (layers, "ln_matmul", ln_plain), (transformer, "ln_matmul", ln_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@torch.no_grad()
def phase_denoiser(pipe):
    from this_and_that_vdm_tpu_torch import ops

    b, h, w = 2, H // 8, W // 8
    g = torch.Generator(device="cuda").manual_seed(7)
    inp = torch.randn((b, F, h, w, 8), generator=g, device="cuda")
    cond = torch.randn((b, F, h, w, 4), generator=g, device="cuda")
    states = torch.randn((b, 78, 1024), generator=g, device="cuda")
    ids = torch.tensor([[6.0, 127.0, 0.02]] * b, device="cuda")
    t = torch.tensor(0.25 * np.log(700.0), device="cuda")

    def forward():
        res, mid = pipe.controlnet(inp, t, states, ids, cond, conditioning_scale=1.0)
        return pipe.unet(inp, t, states, ids, down_block_additional_residuals=res,
                         mid_block_additional_residual=mid).float()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = forward()
    sync()
    t_kern = time.perf_counter() - t0
    counts = ops.launch_counts()
    with plain_versions():
        t0 = time.perf_counter()
        want = forward()
        sync()
        t_plain = time.perf_counter() - t0
    rel_l2 = ((got - want).norm() / want.norm()).item()
    log(f"[denoiser] ControlNet+UNet [2,14,32,48] bf16: rel L2 {rel_l2:.3e} "
        f"(bound {DENOISER_REL_L2_BOUND:.0e}); launches {counts}; first-call wall "
        f"kernels {t_kern:.3f} s, plain {t_plain:.3f} s")
    if not torch.isfinite(got).all() or not rel_l2 < DENOISER_REL_L2_BOUND:
        raise RuntimeError(f"denoiser check failed: rel L2 {rel_l2}")
    if min(counts.values()) == 0:
        raise RuntimeError(f"denoiser forward skipped a kernel: {counts}")
    return rel_l2


def gesture_raster(points, seed):
    """[F, H, W, 3] in [0, 1], BGR: zero frames except each point's frame,
    a white canvas with a blurred dot (first point red, second green)."""
    colors = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    raster = np.zeros((F, H, W, 3), np.float32)
    for i, (frame, x, y) in enumerate(points):
        m = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0 ** 2))[..., None]
        raster[frame] = (1.0 - m) + m * np.asarray(colors[min(i, 1)], np.float32)
    return raster


def request_inputs(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand((1, 3, 8, 12), generator=g, device="cuda") * 2 - 1
    image = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                            align_corners=False).permute(0, 2, 3, 1)
    ids = torch.randint(0, 49408, (1, 77), generator=g, device="cuda")
    return image.contiguous(), ids, g


@torch.no_grad()
def phase_slice(pipe, smi):
    from this_and_that_vdm_tpu_torch import ops

    requests = [dict(points=[(0, 150.0, 120.0)], seed=11, steps=STEPS[0]),
                dict(points=[(0, 120.0, 100.0), (F - 1, 260.0, 150.0)], seed=22, steps=STEPS[1])]
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stages = []
    for i, req in enumerate(requests):
        image, ids, gen = request_inputs(req["seed"])
        trace = {}
        t0 = time.perf_counter()
        frames = pipe(image, gesture_raster(req["points"], req["seed"]), prompt_ids=ids,
                      num_frames=F, num_inference_steps=req["steps"],
                      decode_chunk_size=DECODE_CHUNK, generator=gen, output_type="uint8",
                      trace=trace)
        total = time.perf_counter() - t0
        lat = trace.pop("latents").float()
        if frames.shape != (1, F, H, W, 3) or frames.dtype != np.uint8:
            raise RuntimeError(f"request {i + 1}: frames {frames.shape} {frames.dtype}")
        if not torch.isfinite(lat).all() or not lat.std().item() > 0:
            raise RuntimeError(f"request {i + 1}: latents not finite or constant")
        stage = {k: round(v, 4) for k, v in trace.items()}
        stages.append(dict(request=i + 1, points=len(req["points"]), steps=req["steps"],
                           total_s=round(total, 4), **stage,
                           latents_std=lat.std().item(), frames_mean=float(frames.mean())))
        log(f"[slice] request {i + 1}: {len(req['points'])}-point gesture, {req['steps']} steps, "
            f"frames {frames.shape} {frames.dtype}; stages (s) {stage}; total {total:.3f} s; "
            f"latents std {lat.std().item():.4f}  [{smi}]")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] launches over both requests {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB  [{smi}]")
    if min(counts.values()) == 0:
        raise RuntimeError(f"the main path skipped a kernel: {counts}")
    return counts, stages, peak


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    pipe = build_pipeline()
    rel_l2 = phase_denoiser(pipe)
    counts, stages, peak = phase_slice(pipe, smi)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = kern[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=counts[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels,
                       kernel_cases={k: v["cases"] for k, v in kern.items()},
                       denoiser_rel_l2=rel_l2, requests=stages, peak_bytes=peak,
                       wall_s=time.perf_counter() - t_start), f, indent=1)
    log(f"[done] wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
