"""Drive the PyTorch port's VGL clip, its entry points (weight loading, the
server, the batch-inference CLI) and its VGL / VL training once on one CUDA
card, with its kernels.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. device      a CUDA card must be present; prints its name and power
                 limit; TF32 is turned off for matmuls and cuDNN convolutions
                 (the comparisons below are against full-precision plain math)
  2. build       nvcc builds the Hopper kernels from csrc/ into build/; the
                 SASS of the bf16 K1 and K3 kernels must show wgmma (HGMMA)
                 and TMA loads (UTMALDG) and no mma.sync (HMMA), that of the
                 fp32 K1 and K3 kernels tensor-core products (HMMA or HGMMA)
  3. kernels     each kernel against its plain PyTorch version on the card, at
                 the slices' shapes, in bf16 and fp32 (K4: fp32 steps, uint8
                 codes), with its time beside the plain version's, the time of
                 the PyTorch library call for the same function where there is
                 one, and the least time the card could take (bound).  K1 and
                 K3 bf16 at every shape of the denoise step: K1 contiguous and
                 as the .chunk(3) views of a fused qkv product, K3 at every
                 (R, C, N) of its LN -> projection sites; K1 and K3 fp32 at
                 the shapes of both and at those of the batch-1 train
                 steps; K2 at every GroupNorm site of the denoise step,
                 labelled with its route (resident in shared memory or
                 streamed), at the VAE decoder's and the fp32 train sites,
                 and on constant input; K4 one leaf at a time and over the
                 GestureNet's 655 leaves in one call.  Each case also gets
                 its device time a call (torch.profiler over as many calls
                 as the events time) and its count of device activities a
                 call.  Then the backward of K1-K3 against autograd of the
                 plain versions
  4. denoiser    one full-width ControlNet + UNet forward (CFG batch 2, 14
                 frames of 32x48 latents, bf16) with the kernels and through
                 the plain versions; relative L2 error held to a bound; then
                 one more forward under torch.profiler: device ms by kernel,
                 the device-busy share of its span, K1 and K3 ms per step,
                 K2's ms and launches beside its bound for the step (one
                 read and one write of every GroupNorm input)
  5. slice       StableVideoDiffusionControlNetPipeline at full width (seeded
                 random weights, bf16) answers two VGL requests (14 frames of
                 256x384, 1-point and 2-point gesture rasters); the launch
                 counters show every kernel ran on that path
  8. entry       (runs after phase 5, before the training phases) the phase-5
                 models written through weights/export as an HF-layout fp16
                 tree with a tokenizer folder, loaded back through
                 weights/loader.load_pretrained (every tensor bit for bit
                 against its fp16-rounded original); three requests from
                 three threads through serving.VideoGenServer (25 steps,
                 gestures rasterised by data/rasterize, prompts through the
                 port's tokenizer): shapes, finite latents, queue wait and
                 latency; a served 4-step request bit for bit against a direct
                 call; a batch of two against each served alone (latents
                 rel L2, PSNR, one pipeline call); cli.inference.main over two
                 instances (im_0.jpg as PNG bytes); the launch counters of the
                 serve and CLI paths must show K1-K3
  6. VGL train   training.train_loop.main on config/train_image2video_gesturenet.yaml
                 as written (14x256x384, batch 1, remat, bf16 frozen towers
                 and UNet, fp32 GestureNet, 8-bit AdamW, clip 1.0), 3 steps
                 of synthetic data into a temporary output directory; the
                 last step runs under torch.profiler (device time by kernel;
                 K2's and K4's ms and launches beside their bounds for the
                 step); the host ms of each optimizer update
  7. VL train    the same on config/train_image2video.yaml (the 1.525 B-param
                 UNet trains in fp32), 3 steps, the last one profiled

Prints, before the last line, one JSON line with each kernel's launches
(summed over the paths of phases 5-8, each counted from zero), error, times and bound,
and the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}.  A longer report goes to
chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

# K4 (8-bit Adam): step error over max |step| below 1e-5; codes off by at
# most 1 on under 0.1% of entries (a log2 at a codebook midpoint may round
# either way); scales within 1e-6 relative.
K4_STEP_BOUND, K4_CODE_SHARE, K4_SCALE_BOUND = 1e-5, 1e-3, 1e-6

KERNEL_INFO = {
    "flash_attention": ("this_and_that_vdm_tpu_torch/csrc/flash_attention.cu",
                        "this_and_that_vdm_tpu/ops/flash_attention.py:58"),
    "groupnorm": ("this_and_that_vdm_tpu_torch/csrc/groupnorm.cu",
                  "this_and_that_vdm_tpu/ops/groupnorm_pallas.py:43"),
    "ln_matmul": ("this_and_that_vdm_tpu_torch/csrc/ln_matmul.cu",
                  "this_and_that_vdm_tpu/ops/ln_matmul.py:74"),
    "adam8bit": ("this_and_that_vdm_tpu_torch/csrc/adam8bit.cu",
                 "this_and_that_vdm_tpu/ops/adam8bit_pallas.py:53"),
}

INFERENCE_KERNELS = ("flash_attention", "groupnorm", "ln_matmul")  # K4 runs in training only

# Main-path shapes (the denoise step at CFG 2: 28 = 2 x 14 frames).  K1:
# (shape, as .chunk(3) views of a fused qkv product); the first bf16 case is
# the one the kernels line reports.  K3: (R, C, N, bias) of every LN ->
# projection site: levels 1-3 and the level-4 mid block, N = C (the
# cross-attention q), 3C (the fused qkv), 8C (the GEGLU input, with bias).
# fp32 adds the shapes of the batch-1 train steps (14 frames: half the rows):
# K1 at S = 1536 and 384, K3 at each level's N = C, 3C, 8C and the VL mid
# block's qkv (R = 336).
K1_SHAPES = {torch.bfloat16: [((28, 1536, 5, 64), True), ((28, 1536, 5, 64), False),
                              ((28, 384, 10, 64), True), ((28, 384, 10, 64), False),
                              ((4, 1000, 5, 64), False)],
             torch.float32: [((28, 1536, 5, 64), False), ((28, 384, 10, 64), False),
                             ((4, 1000, 5, 64), False), ((14, 1536, 5, 64), True),
                             ((14, 384, 10, 64), True)]}
_K3_ROWS = ((43008, 320), (10752, 640), (2688, 1280), (672, 1280))
_K3_TRAIN_ROWS = ((21504, 320), (5376, 640), (1344, 1280))
K3_SHAPES = {torch.bfloat16: [(r, c, n, n == 8 * c) for r, c in _K3_ROWS
                              for n in (3 * c, c, 8 * c)],
             torch.float32: [(43008, 320, 960, False), (43008, 320, 2560, True),
                             (2688, 1280, 10240, True)]
             + [(r, c, n, n == 8 * c) for r, c in _K3_TRAIN_ROWS for n in (c, 3 * c, 8 * c)]
             + [(336, 1280, 3840, False)]}

# K2 cases, every distinct GroupNorm site (shape, eps, SiLU) of the denoise
# step at CFG 2 (bf16; rank 5 folds frames into the statistics): 152 calls
# over these 25 sites; the first is the one the kernels line reports.  Then
# the VAE decoder's largest sites (chunk 8) and the batch-1 train sites, in
# fp32 for the GestureNet and the VL UNet.  A site of at most 27.5 MB is
# held in shared memory (the resident route), a larger one is streamed.
K2_DENOISE = [((28, 32, 48, 320), 1e-6, True), ((2, 14, 32, 48, 320), 1e-6, True),
              ((28, 32, 48, 320), 1e-6, False), ((28, 32, 48, 320), 1e-5, True),
              ((28, 32, 48, 960), 1e-6, True), ((28, 32, 48, 640), 1e-6, True),
              ((28, 16, 24, 1920), 1e-6, True), ((28, 16, 24, 1280), 1e-6, True),
              ((28, 16, 24, 960), 1e-6, True), ((28, 16, 24, 640), 1e-6, True),
              ((2, 14, 16, 24, 640), 1e-6, True), ((28, 16, 24, 640), 1e-6, False),
              ((28, 8, 12, 2560), 1e-6, True), ((28, 8, 12, 1920), 1e-6, True),
              ((28, 16, 24, 320), 1e-6, True), ((28, 8, 12, 1280), 1e-6, True),
              ((2, 14, 8, 12, 1280), 1e-6, True), ((28, 8, 12, 1280), 1e-6, False),
              ((28, 8, 12, 640), 1e-6, True), ((28, 4, 6, 2560), 1e-6, True),
              ((28, 4, 6, 1280), 1e-5, True), ((2, 14, 4, 6, 1280), 1e-5, True),
              ((28, 4, 6, 1280), 1e-6, False), ((28, 4, 6, 1280), 1e-6, True),
              ((2, 14, 4, 6, 1280), 1e-6, True)]
K2_OTHER = {torch.bfloat16: [((8, 256, 384, 128), 1e-6, False), ((1, 8, 256, 384, 128), 1e-5, True),
                             ((8, 256, 384, 256), 1e-6, True), ((2, 14 * 1536, 320), 1e-5, True)],
            torch.float32: [((14, 32, 48, 320), 1e-6, True), ((1, 14, 32, 48, 320), 1e-6, True),
                            ((14, 16, 24, 640), 1e-6, True), ((14, 8, 12, 1280), 1e-6, True),
                            ((14, 4, 6, 1280), 1e-5, True), ((14, 32, 48, 640), 1e-6, True),
                            ((14, 32, 48, 960), 1e-6, True), ((14, 16, 24, 1920), 1e-6, True),
                            ((14, 4, 6, 2560), 1e-6, True), ((28, 1536, 320), 1e-6, True),
                            ((2, 14 * 1536, 320), 1e-5, True), ((8, 256 * 384, 128), 1e-6, False)]}
# the constant-input case (zero-variance groups) on each route
K2_CONSTANT = [(28, 1536, 320), (28, 1536, 640)]

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and operations/s
# by type.  bf16 runs on the tensor cores at 989 TFLOP/s.  The fp32 kernels
# keep fp32 accuracy on the tensor cores with three TF32 products for every
# product (3xTF32), so their peak is 495 / 3 = 165 TFLOP/s of fp32 work, not
# the CUDA cores' 67 TFLOP/s (which a 3xTF32 kernel can exceed).
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
# (mode, config, steps, profile the last step)
TRAIN_CONFIGS = (("vgl", "config/train_image2video_gesturenet.yaml", 3, True),
                 ("vl", "config/train_image2video.yaml", 3, True))


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
    sass_check(_native.library_path())


# kernels that must run on wgmma (HGMMA) with TMA loads (UTMALDG) and no
# mma.sync (HMMA), and kernels that must run on the tensor cores (HMMA or
# HGMMA); each name is matched as a template (name + "I" in the mangled
# name), so the streamed K3's row pass, ln_matmul_f32_rows, is not a product
HOPPER_KERNELS = ("flash_bf16", "ln_matmul_bf16")
TENSOR_CORE_KERNELS = ("flash_f32", "ln_matmul_f32")


def sass_check(lib):
    """Count the SASS opcodes of the K1 and K3 kernels in the built
    library; raise if a bf16 one lacks HGMMA or UTMALDG or still has HMMA,
    or an fp32 one has neither HMMA nor HGMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("SASS check: cuobjdump not found on PATH or in /usr/local/cuda/bin")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, cur = {}, None
    kinds = HOPPER_KERNELS + TENSOR_CORE_KERNELS
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            cur = name if any(k + "I" in name for k in kinds) else None
            if cur:
                counts[cur] = dict.fromkeys(("HGMMA", "UTMALDG", "HMMA"), 0)
        elif cur:
            for op in counts[cur]:
                counts[cur][op] += f" {op}." in line or f" {op} " in line

    def bad(name, c):
        if any(k + "I" in name for k in HOPPER_KERNELS):
            return not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]
        return not (c["HMMA"] or c["HGMMA"])

    missing = sorted(k for k in kinds if not any(k + "I" in n for n in counts))
    failed = [n for n, c in counts.items() if bad(n, c)]

    def short(name):  # flash_bf16<64>, ln_matmul_f32<128,128,4,4,32,3,0> from the mangled name
        m = re.search(r"(" + "|".join(kinds) + r")I", name)
        return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', name[m.end():]))}>"

    log("[build] SASS of the K1 / K3 kernels: "
        + "; ".join(f"{short(n)} {c}" for n, c in counts.items()))
    if failed or missing:
        raise RuntimeError(f"SASS check failed: {failed or missing}")


# ----------------------------------------------------------------- phase 3

def _randn(shape, dtype, seed, scale=1.0, shift=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)


def bound(flops, nbytes, dtype):
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def kernel_cases():
    """Dicts (kernel, label, kern, plain, scale, work, library) at the slices'
    shapes; the error is relative to ``scale``, else to max |plain|; ``work``
    = (operations, bytes, dtype) of one call; ``library``: one PyTorch call
    (or a pair, noted) computing the same function, timed as a yardstick."""
    import torch.nn.functional as tF

    from this_and_that_vdm_tpu_torch.ops import flash_attention as fa
    from this_and_that_vdm_tpu_torch.ops import groupnorm as gn
    from this_and_that_vdm_tpu_torch.ops import ln_matmul as lm

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "fp32"
        isz = torch.finfo(dtype).bits // 8
        for shape, views in K1_SHAPES[dtype]:
            b, sq, h, d = shape
            if views:  # the .chunk(3) views of a fused [B, S, 3C] qkv product, as on the path
                qkv = _randn((b, sq, 3 * h * d), dtype, 0)
                q, k, v = (t.reshape(shape) for t in qkv.chunk(3, dim=-1))
            else:
                q, k, v = (_randn(shape, dtype, s) for s in range(3))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D] views
            cases.append(dict(
                kernel="flash_attention", device_key=f"flash_attention {dn}",
                label=f"{list(shape)}{' qkv views' if views else ''} {dn}",
                kern=lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, 0.125),
                plain=lambda q=q, k=k, v=v: fa._plain(q, k, v, 0.125), scale=None,
                work=(4.0 * b * h * sq * sq * d, 4.0 * q.numel() * isz, dtype),
                library=lambda q=qt, k=kt, v=vt: tF.scaled_dot_product_attention(
                    q, k, v, scale=0.125),
                library_note="F.scaled_dot_product_attention"))
        gn_sites = ([(sh, e, sl, False) for sh, e, sl in (K2_DENOISE if dtype == torch.bfloat16
                                                           else [])]
                    + [(sh, e, sl, False) for sh, e, sl in K2_OTHER[dtype]]
                    + [(sh, 1e-6, False, True) for sh in K2_CONSTANT])
        for shape, eps, silu, const in gn_sites:
            c = shape[-1]
            x = (torch.full(shape, 3.0, device="cuda", dtype=dtype) if const
                 else _randn(shape, dtype, 4, 2.0, 0.5))
            w, b = _randn((c,), torch.float32, 5, 0.1, 1.0), _randn((c,), torch.float32, 6, 0.1)
            wl, bl = w.to(dtype), b.to(dtype)
            xcf = x.reshape(shape[0], -1, c).permute(0, 2, 1)  # channels-first view

            def library(x=xcf, w=wl, b=bl, e=eps, s=silu):
                y = tF.group_norm(x, 32, w, b, e)
                return tF.silu(y) if s else y

            p = gn.plan(shape[0], x.numel() // (shape[0] * c), c, 32, x.element_size(),
                        torch.cuda.get_device_properties(0).multi_processor_count)
            route = "resident" if p.resident else "streamed"
            label = (f"{list(shape)} eps={eps} silu={silu}{' constant' if const else ''} {dn} "
                     f"{route}")
            cases.append(dict(
                kernel="groupnorm", label=label, device_key="groupnorm",
                kern=lambda x=x, w=w, b=b, e=eps, s=silu: gn.group_norm(x, w, b, 32, e, s),
                plain=lambda x=x, w=w, b=b, e=eps, s=silu: gn._plain(x, w, b, 32, e, s),
                scale=3.0 * w.abs().max().item() / eps ** 0.5 if const else None,
                work=((8.0 if silu else 5.0) * x.numel(), 2.0 * x.numel() * isz,
                      torch.float32),
                library=library,
                library_note="F.group_norm" + (" + F.silu (two calls)" if silu else "")))
        for r, c, n, bias in K3_SHAPES[dtype]:
            x = _randn((r, c), dtype, 7)
            s, b = _randn((c,), torch.float32, 8, 0.1, 1.0), _randn((c,), torch.float32, 9, 0.1)
            w = _randn((n, c), dtype, 10, c ** -0.5)
            wb = _randn((n,), torch.float32, 11, 0.1) if bias else None
            sl, bl = s.to(dtype), b.to(dtype)
            wbl = None if wb is None else wb.to(dtype)
            cases.append(dict(
                kernel="ln_matmul", label=f"R={r} C={c} N={n} bias={bias} {dn}",
                device_key=f"ln_matmul {dn}",
                kern=lambda x=x, s=s, b=b, w=w, wb=wb: lm.ln_matmul(x, s, b, w, wb),
                plain=lambda x=x, s=s, b=b, w=w, wb=wb: lm._reference(x, s, b, w, wb, 1e-5),
                scale=None,
                work=(2.0 * r * c * n, (r * c + n * c + r * n) * isz + 8.0 * c + 4.0 * n,
                      dtype),
                library=lambda x=x, s=sl, b=bl, w=w, wb=wbl: tF.linear(
                    tF.layer_norm(x, (x.shape[-1],), s, b, 1e-5), w, wb),
                library_note="F.layer_norm -> F.linear (two calls)"))
    return cases


def k4_inputs(nb, seed, valid=None):
    """Gradient blocks and a moment state on the card; entries past ``valid``
    are the zero-padded tail of a ragged leaf (zero gradient, zero codes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grad = torch.randn((nb, 256), generator=g, device="cuda") * 1e-3
    mq = torch.randint(0, 255, (nb, 256), generator=g, device="cuda").to(torch.uint8)
    nq = torch.randint(0, 256, (nb, 256), generator=g, device="cuda").to(torch.uint8)
    ms = torch.rand((nb,), generator=g, device="cuda") * 1e-3
    ns = torch.rand((nb,), generator=g, device="cuda") * 1e-6
    if valid is not None:
        grad.view(-1)[valid:] = 0
        mq.view(-1)[valid:] = 127
        nq.view(-1)[valid:] = 0
    return grad, mq, ms, nq, ns


def k4_compare(got, want):
    """(max abs step error, step error / max |step|); raises past the K4 bounds."""
    (step, mq, ms, nq, ns), (wstep, wmq, wms, wnq, wns) = got, want
    abs_err = (step - wstep).abs().max().item()
    rel = abs_err / wstep.abs().max().item()
    off = max(((a.int() - b.int()).abs() > 0).float().mean().item() for a, b in
              ((mq, wmq), (nq, wnq)))
    far = max((a.int() - b.int()).abs().max().item() for a, b in ((mq, wmq), (nq, wnq)))
    scale_rel = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                    for a, b in ((ms, wms), (ns, wns)))
    if not (rel < K4_STEP_BOUND and far <= 1 and off < K4_CODE_SHARE
            and scale_rel <= K4_SCALE_BOUND):
        raise RuntimeError(f"adam8bit: step rel {rel:.3e}, codes off {off:.2e} (max {far}), "
                           f"scales rel {scale_rel:.3e}")
    return abs_err, rel, off


def gesturenet_numels():
    """Element counts of the GestureNet's trainable leaves (the whole
    ControlNet at its published widths), read from a model on the meta
    device: the VGL train step's tree."""
    from this_and_that_vdm_tpu_torch.models.controlnet import ControlNetConfig, ControlNetModel

    with torch.device("meta"):
        model = ControlNetModel(ControlNetConfig())
    return [p.numel() for p in model.parameters()]


def k4_tree_inputs(numels, seed):
    """Per-leaf gradients and moment states as views of one set of buffers
    (leaf i at its first global block, so every view is 16-byte aligned);
    the ragged tail of each leaf holds the zero codes."""
    from this_and_that_vdm_tpu_torch.ops import adam8bit as k4

    first, total = k4.leaf_blocks(numels)
    grad, mq, ms, nq, ns = k4_inputs(total, seed)
    flat = [t.view(-1) for t in (grad, mq, nq)]
    for f, n in zip(first, numels):
        tail = slice(f * 256 + n, -(-n // 256) * 256 + f * 256)
        flat[1][tail], flat[2][tail] = 127, 0
    gs = [flat[0][f * 256:f * 256 + n] for f, n in zip(first, numels)]
    mqs = [flat[1][f * 256:(f + -(-n // 256)) * 256] for f, n in zip(first, numels)]
    nqs = [flat[2][f * 256:(f + -(-n // 256)) * 256] for f, n in zip(first, numels)]
    mss = [ms[f:f + -(-n // 256)] for f, n in zip(first, numels)]
    nss = [ns[f:f + -(-n // 256)] for f, n in zip(first, numels)]
    return (gs, mqs, mss, nqs, nss), total


def adam8bit_cases():
    """K4 at the 13.1 M-parameter GEGLU leaf (NB = 51,200), a 90-block leaf and
    a ragged 513-element leaf, each at t = 1 and t = 1000 (one-leaf calls);
    then the GestureNet's 655 leaves in one call, at t = 1 and t = 1000."""
    from this_and_that_vdm_tpu_torch.ops import adam8bit as k4

    cases = []
    for nb, valid in ((51200, None), (90, None), (3, 513)):
        ins = k4_inputs(nb, 12, valid)
        n = nb * 256
        for t in (1, 1000):
            bc = k4.bias_corrections(t, 0.9, 0.999)
            cases.append(dict(
                kernel="adam8bit", label=f"NB={nb}{f' ({valid} valid)' if valid else ''} t={t}",
                device_key="adam8bit",
                kern=lambda ins=ins, bc=bc: k4.adam8bit_update(*ins, bc),
                plain=lambda ins=ins, bc=bc: k4._plain(*ins, bc, 0.9, 0.999, 1e-8),
                work=(50.0 * n, 12.0 * n + 16.0 * nb, torch.float32), library=None,
                library_note=None, valid=valid))
    numels = gesturenet_numels()
    ins, total = k4_tree_inputs(numels, 13)
    for t in (1, 1000):
        bc = k4.bias_corrections(t, 0.9, 0.999)
        cases.append(dict(
            kernel="adam8bit", label=f"GestureNet tree: {len(numels)} leaves, "
                                     f"{sum(numels) / 1e9:.4f} B params t={t}",
            device_key="adam8bit", tree=numels,
            kern=lambda ins=ins, bc=bc: k4.adam8bit_leaves(*ins, bc),
            plain=lambda ins=ins, bc=bc: k4._plain_leaves(*ins, bc, 0.9, 0.999, 1e-8),
            work=(50.0 * sum(numels), 12.0 * sum(numels) + 16.0 * total, torch.float32),
            library=None, library_note=None, valid=None))
    return cases


def k4_tree_compare(got, want, numels):
    """The K4 bounds over a tree's update: step error over max |step| and
    scale errors leaf by leaf, codes off by at most 1 everywhere and off on
    under K4_CODE_SHARE of the tree's codes (a share within one leaf of a
    block or two would count a single code as 0.2-0.4%), and the zero codes
    of every ragged tail; (max abs step error, worst step error / max
    |step| of its leaf, share of codes off by 1)."""
    abs_err = rel = 0.0
    off = total = 0
    for i, n in enumerate(numels):
        if not n:
            continue
        (step, mq, ms, nq, ns), (wstep, wmq, wms, wnq, wns) = ([o[i] for o in got],
                                                             [o[i] for o in want])
        d = (step - wstep).abs().max().item()
        abs_err, rel = max(abs_err, d), max(rel, d / wstep.abs().max().item())
        for a, b in ((mq, wmq), (nq, wnq)):
            diff = (a.int() - b.int()).abs()
            if diff.max().item() > 1:
                raise RuntimeError(f"adam8bit tree: leaf {i} has codes off by more than 1")
            off += int((diff > 0).sum().item())
            total += diff.numel()
        scale_rel = max(((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
                        for a, b in ((ms, wms), (ns, wns)))
        if not (rel < K4_STEP_BOUND and scale_rel <= K4_SCALE_BOUND):
            raise RuntimeError(f"adam8bit tree: leaf {i} step rel {rel:.3e}, scales rel "
                               f"{scale_rel:.3e}")
        if not ((got[1][i][n:] == 127).all() and (got[3][i][n:] == 0).all()):
            raise RuntimeError(f"adam8bit tree: leaf {i} lost the zero codes of its tail")
    if not off / total < K4_CODE_SHARE:
        raise RuntimeError(f"adam8bit tree: codes off on {off / total:.2e} of the tree")
    return abs_err, rel, off / total


def profiled_device_ms(fn, key, iters=10):
    """(device ms a launch of the kernel ``key`` of KERNEL_NAMES, device
    activities of any kind a call): ``iters`` calls under torch.profiler,
    after one warm-up, as many calls as ``cuda_ms`` times."""
    fn()
    sync()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    dt = device_time(prof)
    # per launch the profiler saw (it can drop an event of a short burst)
    return (dt["kernels_ms"][key] / max(dt["kernel_launches"][key], 1),
            dt["activities"] / iters)


def phase_kernels():
    results = {name: {"max_abs_err": 0.0, "cases": []} for name in KERNEL_INFO}
    for case in kernel_cases() + adam8bit_cases():
        name, label = case["kernel"], case["label"]
        got, want = case["kern"](), case["plain"]()
        sync()
        if "tree" in case:
            abs_err, rel, off = k4_tree_compare(got, want, case["tree"])
            extra = f"codes off by 1: {off:.2e}"
        elif name == "adam8bit":
            abs_err, rel, off = k4_compare(got, want)
            if case["valid"] is not None and not (
                    (got[1].view(-1)[case["valid"]:] == 127).all()
                    and (got[3].view(-1)[case["valid"]:] == 0).all()):
                raise RuntimeError(f"adam8bit {label}: padded tail lost its zero codes")
            extra = f"codes off by 1: {off:.2e}"
        else:
            if not torch.isfinite(got.float()).all():
                raise RuntimeError(f"{name} {label}: non-finite output")
            abs_err, rel = rel_err(got, want, case["scale"])
            limit = BOUND[got.dtype]
            if not rel < limit:
                raise RuntimeError(f"{name} {label}: relative error {rel:.3e} >= {limit:.0e}")
            extra = f"(bound {limit:.0e})"
        del got, want
        ms, plain_ms = cuda_ms(case["kern"]), cuda_ms(case["plain"])
        lib_ms = cuda_ms(case["library"]) if case["library"] is not None else None
        dev_ms, per_call = profiled_device_ms(case["kern"], case["device_key"])
        bound_ms, bound_by = bound(*case["work"])
        log(f"[kernel] {name:15s} {label:45s} max_abs={abs_err:.3e} rel={rel:.3e} {extra}  "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms, {per_call:g} device activities a "
            f"call)  plain {plain_ms:.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound {bound_ms:.4f} ms "
            f"({bound_by})")
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["cases"].append(dict(case=label, max_abs_err=abs_err, rel_err=rel, ms=ms,
                               device_ms=dev_ms, device_activities_per_call=per_call,
                               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library=case["library_note"]))
        if "ms" not in r:  # first case = the main-path site (bf16 where it applies)
            r.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms, bound_by=bound_by, library=case["library_note"])
    sync()
    torch.cuda.empty_cache()
    return results


def backward_cases():
    """(kernel, label, kernel call, plain call, inputs) at one training-path
    shape each (batch 1 clip of 14 frames), bf16 and fp32."""
    from this_and_that_vdm_tpu_torch.ops import flash_attention as fa
    from this_and_that_vdm_tpu_torch.ops import groupnorm as gn
    from this_and_that_vdm_tpu_torch.ops import ln_matmul as lm

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "fp32"
        f32 = torch.float32
        cases += [
            ("flash_attention", f"[14,1536,5,64] {dn}",
             lambda q, k, v: fa.flash_attention(q, k, v, 0.125),
             lambda q, k, v: fa._plain(q, k, v, 0.125),
             [_randn((14, 1536, 5, 64), dtype, s) for s in range(3)]),
            ("groupnorm", f"[14,1536,320] silu {dn}",
             lambda x, w, b: gn.group_norm(x, w, b, 32, 1e-6, True),
             lambda x, w, b: gn._plain(x, w, b, 32, 1e-6, True),
             [_randn((14, 1536, 320), dtype, 4, 2.0, 0.5), _randn((320,), f32, 5, 0.1, 1.0),
              _randn((320,), f32, 6, 0.1)]),
            ("ln_matmul", f"R=21504 C=320 N=960 {dn}",
             lambda x, s, b, w: lm.ln_matmul(x, s, b, w),
             lambda x, s, b, w: lm._reference(x, s, b, w, None, 1e-5),
             [_randn((21504, 320), dtype, 7), _randn((320,), f32, 8, 0.1, 1.0),
              _randn((320,), f32, 9, 0.1), _randn((960, 320), dtype, 10, 320 ** -0.5)]),
        ]
    return cases


def phase_backward():
    """Gradients through each wrapper (its autograd Function) against
    autograd of the plain version, with the forward bounds."""
    from this_and_that_vdm_tpu_torch import ops

    worst = {}
    for name, label, kern, plain, inputs in backward_cases():
        xs = [t.detach().requires_grad_(True) for t in inputs]
        ys = [t.detach().requires_grad_(True) for t in inputs]
        before = ops.launch_counts()[name]
        out = kern(*xs)
        if out.grad_fn is None or ops.launch_counts()[name] != before + 1:
            raise RuntimeError(f"{name} backward: the wrapper recorded no autograd node")
        r = _randn(out.shape, torch.float32, 11)
        got = torch.autograd.grad((out.float() * r).sum(), xs)
        want = torch.autograd.grad((plain(*ys).float() * r).sum(), ys)
        sync()
        rels = [rel_err(a, b)[1] for a, b in zip(got, want)]
        limit = BOUND[inputs[0].dtype]
        log(f"[backward] {name:15s} {label:28s} grad rel errors "
            + " ".join(f"{x:.2e}" for x in rels) + f" (bound {limit:.0e})")
        if not all(np.isfinite(rels)) or max(rels) >= limit:
            raise RuntimeError(f"{name} {label} backward: relative errors {rels}")
        worst[f"{name} {label}"] = max(rels)
        del xs, ys, out, got, want
    torch.cuda.empty_cache()
    return worst


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


@contextlib.contextmanager
def gn_recorder(sizes):
    """Append the bytes of every GroupNorm input the model code sends to K2
    (``layers.group_norm``) to ``sizes``: K2's bound is one read and one
    write of each."""
    from this_and_that_vdm_tpu_torch.models import layers

    orig = layers.group_norm

    def recorded(x, *args, **kwargs):
        sizes.append(x.numel() * x.element_size())
        return orig(x, *args, **kwargs)

    layers.group_norm = recorded
    try:
        yield sizes
    finally:
        layers.group_norm = orig


@contextlib.contextmanager
def timed_optimizer(host_ms):
    """Append the host milliseconds of every optimizer update (the whole
    ``tx.update`` of the chain, launches enqueued, no synchronisation) that
    ``train_loop.main`` runs to ``host_ms``."""
    from this_and_that_vdm_tpu_torch.training import optimizers, trainer

    orig = trainer.make_optimizer

    def make(*args, **kwargs):
        tx = orig(*args, **kwargs)

        def update(updates, state, params=None):
            t0 = time.perf_counter()
            out = tx.update(updates, state, params)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return optimizers.GradientTransformation(tx.init, update)

    trainer.make_optimizer = make
    try:
        yield host_ms
    finally:
        trainer.make_optimizer = orig


def gn_bound_ms(sizes):
    return 2.0 * sum(sizes) / PEAK_BYTES * 1e3


def k4_bound_ms(numels):
    """K4's least time for a tree: 12 bytes a parameter, 16 a block."""
    return (12.0 * sum(numels) + 16.0 * sum(-(-n // 256) for n in numels)) / PEAK_BYTES * 1e3


def denoiser_step(pipe):
    """One denoise step's model work: ControlNet + UNet at full width, CFG
    batch 2, 14 frames of 32x48 latents, seeded inputs."""
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

    return forward


def profile_step(forward):
    """One call of ``forward`` under torch.profiler: (device_time dict,
    device-busy share of its span, span ms, wall ms)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, span_ms = busy_share(prof)
    return device_time(prof), busy, span_ms, wall_ms


@torch.no_grad()
def phase_denoiser(pipe):
    from this_and_that_vdm_tpu_torch import ops

    forward = denoiser_step(pipe)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with gn_recorder([]) as gn_sizes:
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
    if min(counts[k] for k in INFERENCE_KERNELS) == 0:
        raise RuntimeError(f"denoiser forward skipped a kernel: {counts}")

    # one denoise step (ControlNet + UNet at CFG 2) under the profiler
    prof_dt, busy, span_ms, wall_ms = profile_step(forward)
    ms = prof_dt["kernels_ms"]
    step = dict(device_ms=prof_dt["total_ms"], wall_ms=wall_ms, span_ms=span_ms, busy_share=busy,
                k1_ms=ms["flash_attention bf16"], k3_ms=ms["ln_matmul bf16"], kernels_ms=ms,
                k2_ms=ms["groupnorm"], k2_launches=prof_dt["kernel_launches"]["groupnorm"],
                k2_calls=len(gn_sizes), k2_bound_ms=gn_bound_ms(gn_sizes),
                kernel_launches=prof_dt["kernel_launches"], top_ms=prof_dt["top_ms"])
    log(f"[denoiser] profiled step: device {step['device_ms']:.3f} ms over a {span_ms:.3f} ms "
        f"span (busy {busy:.3f}; wall {wall_ms:.3f} ms under the profiler); K1 "
        f"{step['k1_ms']:.3f} ms, K3 {step['k3_ms']:.3f} ms per step; K2 {step['k2_ms']:.3f} ms "
        f"device over {step['k2_launches']} launches ({len(gn_sizes)} calls, bound "
        f"{step['k2_bound_ms']:.3f} ms); the port's kernels (ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + "; largest: " + "; ".join(f"{n} {t:.3f}" for n, t in prof_dt["top_ms"]))
    return rel_l2, step


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
    if min(counts[k] for k in INFERENCE_KERNELS) == 0:
        raise RuntimeError(f"the main path skipped a kernel: {counts}")
    return counts, stages, peak


# ----------------------------------------------------------------- phase 8

ENTRY = dict(serve_steps=25, check_steps=4, seeds=(7, 8, 9), original=(480, 640))
PROMPTS = ("pick up the red block", "push the cup to the left", "open the drawer")
ENTRY_GESTURES = ([(0, 320.0, 240.0)], [(0, 200.0, 150.0), (F - 1, 430.0, 300.0)],
                  [(0, 500.0, 330.0), (F - 1, 150.0, 120.0)])


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def tree_parent(pipe):
    """The temporary directory if it has room for the fp16 tree (2 bytes a
    parameter, 10% spare), else the checkout's gitignored build/."""
    need = 2.2 * sum(p.numel() for m in (pipe.unet, pipe.controlnet, pipe.vae,
                                         pipe.image_encoder, pipe.text_encoder)
                     for p in m.parameters())
    if shutil.disk_usage(tempfile.gettempdir()).free > need:
        return None
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    return build


def write_tree(pipe, root, smi):
    """The pipeline's five models through the port's writer, as an HF-layout
    fp16-variant tree with a tokenizer folder; returns the expected state of
    each model after the trip through fp16 (on the card)."""
    from this_and_that_vdm_tpu_torch.cli import rehearsal
    from this_and_that_vdm_tpu_torch.weights.export import save_hf_layout

    models = dict(unet=pipe.unet, gesturenet=pipe.controlnet, vae=pipe.vae,
                  image_encoder=pipe.image_encoder, text_encoder=pipe.text_encoder)
    free = shutil.disk_usage(root).free
    log(f"[entry] free disk space at the tree's directory: {free / 2**30:.2f} GiB  [{smi}]")
    t0 = time.perf_counter()
    for name, m in models.items():
        save_hf_layout(m, root, name, variant="fp16")
    rehearsal._write_tokenizer(root)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    log(f"[entry] wrote the fp16 tree: {nbytes} bytes in {write_s:.3f} s "
        f"({nbytes / write_s / 1e9:.3f} GB/s)  [{smi}]")
    expected = {name: {k: t.to(torch.float16).float().to(t.dtype) for k, t in
                       m.state_dict().items()} for name, m in models.items()}
    return expected, dict(bytes=nbytes, write_s=write_s, free_bytes=free)


def gif_frames(path):
    """(frames, width, height) of a GIF, from its blocks."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise RuntimeError(f"{path}: not a GIF")
    w, h, flags = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little"), data[10]
    pos, frames = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0), 0

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos = skip_blocks(pos + 2)
        elif data[pos] == 0x2C:
            frames += 1
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_blocks(pos + 1)
        else:
            raise RuntimeError(f"{path}: unexpected GIF block {data[pos]:#x}")
    return frames, w, h


class CountingPipe:
    """The pipeline, with each call's batch size recorded."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, images, *args, **kw):
        self.calls.append(len(images))
        return self.pipe(images, *args, **kw)


def instance_image(seed, hw):
    """A smooth seeded RGB uint8 image at ``hw``: coarse noise, bicubic up."""
    from this_and_that_vdm_tpu_torch.data.image import resize_bicubic

    coarse = (np.random.RandomState(seed).rand(6, 8, 3) * 255).astype(np.uint8)
    return resize_bicubic(coarse, *hw)


def write_instances(root, n=2):
    """``n`` instance folders: ``im_0.jpg`` as PNG bytes (read by content,
    as cv2.imread reads), ``lang.txt``, ``data.txt`` (the gestures above, at
    the original 480x640)."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    for i in range(n):
        d = os.path.join(root, f"Instance{i}")
        os.makedirs(d)
        video_io.write_png(os.path.join(d, "im_0.jpg"), instance_image(100 + i, ENTRY["original"]))
        with open(os.path.join(d, "lang.txt"), "w") as f:
            f.write(PROMPTS[i] + "\n")
        with open(os.path.join(d, "data.txt"), "w") as f:
            f.write("".join(f"{fr} {x} {y}\n" for fr, x, y in ENTRY_GESTURES[i + 1]))


@torch.no_grad()
def phase_entry_points(tree, expected, smi, device="cuda", dtype=torch.bfloat16,
                       scale="full", dims=(F, H, W)):
    """Phase 8 on the tree ``write_tree`` wrote: load it back and hold every
    tensor bit for bit; serve three threaded requests through VideoGenServer;
    a served request against a direct call (bit for bit); a batch of two
    against each served alone; the batch-inference CLI over two instances.
    Returns (report, launch counts of the serve path, of the CLI path)."""
    import threading

    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.cli import inference
    from this_and_that_vdm_tpu_torch.cli.tokenizer import CLIPTokenizer
    from this_and_that_vdm_tpu_torch.data.rasterize import rasterize_gesture_points
    from this_and_that_vdm_tpu_torch.serving import VideoGenServer
    from this_and_that_vdm_tpu_torch.utils import video_io
    from this_and_that_vdm_tpu_torch.weights import loader

    fr, h, w = dims
    rep = {}
    t0 = time.perf_counter()
    pipe = loader.load_pretrained(tree, "vgl", device, dtype, scale=scale)
    if device != "cpu":
        sync()
    rep["load_s"] = time.perf_counter() - t0
    loaded = dict(unet=pipe.unet, gesturenet=pipe.controlnet, vae=pipe.vae,
                  image_encoder=pipe.image_encoder, text_encoder=pipe.text_encoder)
    n_tensors = 0
    for name, m in loaded.items():
        got = m.state_dict()
        if set(got) != set(expected[name]):
            raise RuntimeError(f"entry: {name} loaded keys differ from the written ones")
        for k, want in expected[name].items():
            if got[k].dtype != want.dtype or not torch.equal(_bits(got[k]), _bits(want)):
                raise RuntimeError(f"entry: {name}.{k} is not the fp16-rounded original")
            n_tensors += 1
    expected.clear()
    log(f"[entry] loaded the tree in {rep['load_s']:.3f} s; {n_tensors} tensors bit-equal to "
        f"the fp16-rounded originals  [{smi}]")

    tok = CLIPTokenizer.from_pretrained(tree)
    images = [instance_image(s, (h, w)).astype(np.float32) / 127.5 - 1.0 for s in ENTRY["seeds"]]
    conds = [rasterize_gesture_points(g, ENTRY["original"], (h, w), fr) for g in ENTRY_GESTURES]
    ids = [tok([p])[0] for p in PROMPTS]
    common = dict(num_frames=fr, decode_chunk_size=DECODE_CHUNK, output_type="uint8")

    # threaded requests, one clip a call
    ops.reset_launch_counts()
    traces, futs, done_at, submit_at = [{} for _ in range(3)], [None] * 3, [0.0] * 3, [0.0] * 3
    with VideoGenServer(pipe, num_inference_steps=ENTRY["serve_steps"], **common) as server:
        def submit(i):
            submit_at[i] = time.perf_counter()
            futs[i] = server.submit(images[i], condition=conds[i], prompt_ids=ids[i],
                                    seed=ENTRY["seeds"][i], trace=traces[i])
            futs[i].add_done_callback(lambda _, i=i: done_at.__setitem__(i, time.perf_counter()))

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [f.result(timeout=900) for f in futs]
    serve_counts = ops.launch_counts()
    rep["serve"] = []
    for i, (out, f, tr) in enumerate(zip(outs, futs, traces)):
        lat = tr.pop("latents").float()
        if out.shape != (fr, h, w, 3) or out.dtype != np.uint8:
            raise RuntimeError(f"entry: request {i} gave {out.shape} {out.dtype}")
        if not torch.isfinite(lat).all() or not lat.std().item() > 0:
            raise RuntimeError(f"entry: request {i}: latents not finite or constant")
        r = dict(seed=ENTRY["seeds"][i], points=len(ENTRY_GESTURES[i]),
                 queue_s=f.timing["queue_s"], latency_s=done_at[i] - submit_at[i],
                 stages={k: round(v, 4) for k, v in tr.items()}, latents_std=lat.std().item())
        rep["serve"].append(r)
        log(f"[entry] served request {i} ({r['points']}-point gesture, seed {r['seed']}, "
            f"{ENTRY['serve_steps']} steps): frames {out.shape} {out.dtype}; queue wait "
            f"{r['queue_s']:.3f} s, latency {r['latency_s']:.3f} s; stages (s) {r['stages']}; "
            f"latents std {r['latents_std']:.4f}  [{smi}]")
    log(f"[entry] serve path launches {serve_counts}  [{smi}]")

    # a served request equals a direct call with the request's generator
    short = dict(common, num_inference_steps=ENTRY["check_steps"])
    with VideoGenServer(pipe, **short) as server:
        served = server.submit(images[0], condition=conds[0], prompt_ids=ids[0],
                               seed=ENTRY["seeds"][0]).result(timeout=900)
    direct = pipe(images[0][None], conds[0], prompt_ids=ids[0][None],
                  generator=torch.Generator(device=device).manual_seed(ENTRY["seeds"][0]),
                  **short)[0]
    rep["served_equals_direct"] = bool(np.array_equal(served, direct))
    log(f"[entry] served ({ENTRY['check_steps']} steps) == direct call bit for bit: "
        f"{rep['served_equals_direct']}  [{smi}]")
    if not rep["served_equals_direct"]:
        raise RuntimeError("entry: a served request differs from the direct call")

    # a batch of two against each served alone
    alone, alone_lat = [], []
    with VideoGenServer(pipe, **short) as server:
        for i in (1, 2):
            tr = {}
            alone.append(server.submit(images[i], condition=conds[i], prompt_ids=ids[i],
                                       seed=ENTRY["seeds"][i], trace=tr).result(timeout=900))
            alone_lat.append(tr["latents"].float())
    counting, shared = CountingPipe(pipe), {}
    with VideoGenServer(counting, max_batch=2, max_delay_s=5.0, trace=shared, **short) as server:
        bf = [server.submit(images[i], condition=conds[i], prompt_ids=ids[i],
                            seed=ENTRY["seeds"][i]) for i in (1, 2)]
        batched = [f.result(timeout=900) for f in bf]
    if counting.calls != [2]:
        raise RuntimeError(f"entry: the batch took pipeline calls of sizes {counting.calls}")
    rel = [((shared["latents"][j].float() - a[0]).norm() / a[0].norm()).item()
           for j, a in enumerate(alone_lat)]
    psnrs = [video_io.psnr(b, a) for b, a in zip(batched, alone)]
    rep["batched"] = dict(calls=counting.calls, latents_rel_l2=rel, psnr=psnrs)
    log(f"[entry] batch of 2 in {counting.calls} pipeline call(s): final latents rel L2 "
        f"against served alone {[f'{x:.3e}' for x in rel]} (bound {DENOISER_REL_L2_BOUND:.0e}); "
        f"uint8 frames PSNR {[round(x, 3) for x in psnrs]} dB  [{smi}]")
    if not all(np.isfinite(rel)) or max(rel) > DENOISER_REL_L2_BOUND:
        raise RuntimeError(f"entry: batched latents rel L2 {rel}")
    del pipe, counting, server
    if device != "cpu":
        torch.cuda.empty_cache()

    # the batch-inference CLI over two instances
    val, out = os.path.join(tree, "instances"), os.path.join(tree, "rendered")
    write_instances(val)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = inference.main(["--pretrained", tree, "--model-type", "GestureNet", "--model-scale",
                           scale, "--device", device, "--dtype",
                           "bf16" if dtype == torch.bfloat16 else "f32",
                           "--num-inference-steps", str(ENTRY["serve_steps"]),
                           "--num-frames", str(fr), "--height", str(h), "--width", str(w),
                           "--validation-path", val, "--store-dir", out])
    cli_s = time.perf_counter() - t0
    cli_counts = ops.launch_counts()
    checks = []
    for d in outs:
        frames = video_io.load_frames_dir(d)
        gif = gif_frames(os.path.join(d, "combined.gif"))
        with open(os.path.join(d, "lang_cond.txt")) as f:
            prompt = f.read().strip()
        checks.append(dict(instance=os.path.basename(d), pngs=len(frames),
                           shape=list(frames[0].shape), gif=gif, prompt=prompt))
    rep["cli"] = dict(wall_s=cli_s, instances=checks)
    log(f"[entry] CLI: {len(outs)} instances in {cli_s:.3f} s (load included); {checks}; "
        f"launches {cli_counts}  [{smi}]")
    if [c["instance"] for c in checks] != ["Instance0", "Instance1"] or not all(
            c["pngs"] == fr and c["shape"] == [h, w, 3] and c["gif"] == (fr, w, h)
            and c["prompt"] == PROMPTS[i] for i, c in enumerate(checks)):
        raise RuntimeError(f"entry: CLI outputs {checks}")
    return rep, serve_counts, cli_counts


def _snapshot(tensors):
    """Host copies, so that the checks add nothing to the device's peak."""
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def _same(snap, tensors):
    return all(torch.equal(snap[k], tensors[k].detach().cpu()) for k in snap)


# kernel-name pieces of each kernel of the port, by dtype where it matters;
# "ln_matmul fp32" includes the row pass of its streamed tiles, also shown
# on its own (so the products' launches are the difference)
KERNEL_NAMES = {"flash_attention fp32": ("flash_f32",), "flash_attention bf16": ("flash_bf16",),
                "groupnorm": ("gn_coop",), "ln_matmul fp32": ("ln_matmul_f32",),
                "ln_matmul fp32 row pass": ("ln_matmul_f32_rows",),
                "ln_matmul bf16": ("ln_matmul_bf16",),
                "adam8bit": ("adam8bit_multi",)}


def device_time(prof):
    """Device milliseconds of one profiled step: in total, by kernel of the
    port (with its launches in the step, by kernel name), the ten largest
    kernels by name, and the count of device activities of any kind."""
    by_name, calls = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
            calls[e.key] = calls.get(e.key, 0) + e.count
    ours = {k: sum(t for n, t in by_name.items() if any(p in n for p in pieces))
            for k, pieces in KERNEL_NAMES.items()}
    ours_calls = {k: sum(c for n, c in calls.items() if any(p in n for p in pieces))
                  for k, pieces in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(total_ms=sum(by_name.values()), kernels_ms=ours, kernel_launches=ours_calls,
                top_ms=[(n[:90], t) for n, t in top], activities=sum(calls.values()))


def busy_share(prof):
    """(share of the span from the first kernel's start to the last one's end
    in which a kernel ran, that span in ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    busy, (start, end) = 0.0, spans[0]
    first = start
    for a, b in spans[1:]:
        if a > end:
            busy, start = busy + end - start, a
        end = max(end, b)
    busy += end - start
    return busy / (end - first), (end - first) / 1e3


def phase_train(mode, config, steps, profile, smi):
    """``train_loop.main`` on the shipped YAML (a temporary copy whose
    output_dir is a temporary directory, removed afterwards), ``steps``
    steps of synthetic data; the checks of phases 6 / 7.  With ``profile``
    the last step runs under ``torch.profiler`` and is left out of the
    seconds per step."""
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.training import train_loop

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{mode}_")
    try:
        with open(config) as f:
            lines = [f"output_dir: {tmp}/out" if line.startswith("output_dir:") else line
                     for line in f.read().splitlines()]
        cfg_path = os.path.join(tmp, os.path.basename(config))
        with open(cfg_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        rec = dict(metrics=[], step_s=[], resume=None, checks={})
        snap, gn_sizes, opt_ms = {}, [], []

        def on_step(step, state, m, models):
            # a step's seconds run from the end of one call to the start of
            # the next: the checks below are not part of any step
            sync()
            if rec["resume"] is not None:
                rec["step_s"].append(time.perf_counter() - rec["resume"])
            try:
                checks(step, state, m, models)
            finally:
                sync()
                rec["resume"] = time.perf_counter()

        def checks(step, state, m, models):
            if "prof" in rec:  # the last step ran under the profiler
                rec["prof"].__exit__(None, None, None)
                rec.pop("gn").__exit__(None, None, None)
                rec["profile"] = device_time(rec.pop("prof"))
            adam = state.opt_state[1][0] if mode == "vgl" else state.opt_state[0]
            if step == 0:
                snap["trained"] = _snapshot(state.params)
                if mode == "vgl":
                    snap["unet"] = _snapshot(dict(models["unet"].named_parameters()))
                ops.reset_launch_counts()  # the main path's launches only
                torch.cuda.reset_peak_memory_stats()
                return
            rec["metrics"].append(dict(step=step, loss=float(m["loss"]),
                                       grad_norm=float(m["grad_norm"])))
            if step == 1:  # schedule(0) = 0 with warmup: nothing moves
                rec["checks"]["unchanged_after_step_1"] = _same(snap["trained"], state.params)
            if step == steps:
                rec["checks"]["changed_after_last_step"] = not _same(snap["trained"],
                                                                     state.params)
                rec["checks"]["codes_changed"] = any(
                    bool((q.q != 127).any()) for q in adam.mu.values())
                rec["state_params"] = sum(state.params[k].numel() for k in adam.mu)
                rec["k4_bound_ms"] = k4_bound_ms([state.params[k].numel() for k in adam.mu])
                rec["leaves"] = len(adam.mu)
                rec["checks"]["state_covers_the_tree"] = set(adam.mu) == set(state.params)
                if mode == "vgl":
                    rec["checks"]["unet_bitwise_unchanged"] = _same(
                        snap["unet"], dict(models["unet"].named_parameters()))
                snap.clear()
            if profile and step == steps - 1:  # profile the last step (not timed)
                act = torch.profiler.ProfilerActivity
                rec["gn"] = gn_recorder(gn_sizes)
                rec["gn"].__enter__()
                rec["prof"] = torch.profiler.profile(activities=[act.CPU, act.CUDA])
                rec["prof"].__enter__()

        t0 = time.perf_counter()
        with timed_optimizer(opt_ms):
            train_loop.main(["--config", cfg_path, "--mode", mode, "--synthetic", "4",
                             "--max-steps", str(steps)], on_step=on_step)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = rec["step_s"]
    timed = step_s[1:-1] if profile else step_s[1:]
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    for m in rec["metrics"]:
        log(f"[train {mode}] step {m['step']}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f}")
    prof = rec.get("profile")
    if prof is not None:
        prof.update(k2_bound_ms=gn_bound_ms(gn_sizes), k2_calls=len(gn_sizes),
                    k4_bound_ms=rec["k4_bound_ms"])
        log(f"[train {mode}] profiled step {steps}: K4 {prof['kernels_ms']['adam8bit']:.3f} ms "
            f"device over {prof['kernel_launches']['adam8bit']} launches ({rec['leaves']} "
            f"leaves, bound {rec['k4_bound_ms']:.3f} ms); K2 {prof['kernels_ms']['groupnorm']:.3f}"
            f" ms device over {prof['kernel_launches']['groupnorm']} launches ({len(gn_sizes)} "
            f"calls, bound {prof['k2_bound_ms']:.3f} ms); optimizer update host ms by step "
            f"{[round(t, 3) for t in opt_ms]}  [{smi}]")
        log(f"[train {mode}] profiled step {steps}: device {prof['total_ms']:.1f} ms of "
            f"{step_s[-1] * 1e3:.1f} ms wall; the port's kernels (ms) "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["kernels_ms"].items())
            + "; their launches in the step (by kernel name) "
            + ", ".join(f"{k} {v}" for k, v in prof["kernel_launches"].items())
            + "; largest: " + "; ".join(f"{n} {t:.2f}" for n, t in prof["top_ms"]))
    log(f"[train {mode}] {steps} steps, seconds per step {[round(t, 4) for t in step_s]} "
        f"(timed steps >= 2: {[round(t, 4) for t in timed]}); peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes); TF32 {tf32}; 8-bit state over "
        f"{rec['state_params'] / 1e9:.4f} B parameters; launches {counts}; checks "
        f"{rec['checks']}; wall {wall:.1f} s  [{smi}]")
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
                 for m in rec["metrics"])
    if len(rec["metrics"]) != steps or not finite:
        raise RuntimeError(f"train {mode}: metrics {rec['metrics']}")
    if not all(rec["checks"].values()):
        raise RuntimeError(f"train {mode}: checks failed {rec['checks']}")
    if min(counts.values()) == 0:
        raise RuntimeError(f"train {mode}: the training path skipped a kernel: {counts}")
    return dict(mode=mode, config=config, steps=steps, metrics=rec["metrics"],
                step_s=step_s, timed_step_s=timed, profile=prof, peak_bytes=peak, tf32=tf32,
                launches=counts, optimizer_host_ms=opt_ms,
                checks=rec["checks"], state_params=rec["state_params"], wall_s=wall)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kern = phase_kernels()
    backward = phase_backward()
    pipe = build_pipeline()
    rel_l2, step = phase_denoiser(pipe)
    counts, stages, peak = phase_slice(pipe, smi)
    tree = tempfile.mkdtemp(prefix="chip_smoke_tree_", dir=tree_parent(pipe))
    try:
        expected, tree_rep = write_tree(pipe, tree, smi)
        del pipe
        torch.cuda.empty_cache()
        entry, serve_counts, cli_counts = phase_entry_points(tree, expected, smi)
        entry.update(tree=tree_rep)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    for path, c in (("serve", serve_counts), ("cli", cli_counts)):
        if min(c[k] for k in INFERENCE_KERNELS) == 0:
            raise RuntimeError(f"the {path} path skipped a kernel: {c}")
    torch.cuda.empty_cache()
    train = [phase_train(*args, smi) for args in TRAIN_CONFIGS]
    paths = dict(slice=counts, serve=serve_counts, cli=cli_counts,
                 **{f"train_{t['mode']}": t["launches"] for t in train})

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = kern[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(c.get(name, 0) for c in paths.values()),
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"), "w") as f:
        json.dump(dict(card=smi, kernels=kernels, launches_by_path=paths,
                       kernel_cases={k: v["cases"] for k, v in kern.items()},
                       backward_rel_err=backward, denoiser_rel_l2=rel_l2,
                       denoise_step_profile=step, requests=stages,
                       peak_bytes=peak, entry_points=entry, train=train,
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
