"""Drive the PyTorch port's VGL clip, its entry points (weight loading, the
server, the batch-inference CLI), its VGL / VL training (from a weight folder
and a Bridge-layout dataset, and on synthetic clips), its tools (eval
with LPIPS, the 8-bit AdamW A/B, the app), its curation path (the
This/That labeler and the flow-trajectory stage) and its tracking (SAM +
XMem, FlowFormer, the XMem trainer) once on one CUDA card, with its kernels.

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
  8. entry       (runs after phase 5, before the other phases) the phase-5
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
  9. weights+data (runs after phase 8, on its tree) a Bridge-layout dataset
                 written beside the weights (4 VGL instances of 14 frames, 4
                 VL instances of 20-56 frames, all at 480x640 as PNG bytes
                 under the im_N.jpg names; one validation instance);
                 training.train_loop.main --pretrained on the shipped YAMLs
                 (dataset, tokenizer and validation keys pointed at the
                 trees): VGL 3 steps with a 25-step validation render at step
                 3, VL 2 steps.  Checks: every loaded tensor at step 0
                 bit-equal to phase 8's fp16-rounded original in the dtype it
                 was loaded in; the first batch equal to its source frames
                 (bicubic-resized, subsampled in VL), gesture raster and
                 prompt ids; finite losses, positive gradient norms; the
                 frozen UNet bit-unchanged, the trained model moved; the
                 render's 14 PNGs and GIF; K1-K4 on the train paths, K1-K3
                 on the render.  Then cli.eval with LPIPS on the card (render
                 against itself: 0 and the gate passes; against phase 8's CLI
                 render: > 0; the card's LPIPS within 1e-4 of the CPU's),
                 cli.adam8bit_ab (300 steps, both curves falling, K4 once a
                 step) and the app's one-shot from the tree (4 steps).
                 Prints load, step and render seconds, the loader's wait a
                 step and the peak memory
  6. VGL train   training.train_loop.main on config/train_image2video_gesturenet.yaml
                 as written (14x256x384, batch 1, remat, bf16 frozen towers
                 and UNet, fp32 GestureNet, 8-bit AdamW, clip 1.0), 3 steps
                 of synthetic data into a temporary output directory; the
                 last step runs under torch.profiler (device time by kernel;
                 K2's and K4's ms and launches beside their bounds for the
                 step); the host ms of each optimizer update
  7. VL train    the same on config/train_image2video.yaml (the 1.525 B-param
                 UNet trains in fp32), 3 steps, the last one profiled
 10. curation    (after phase 7) SAM ViT-H, YOLOv8n (one class) and RAFT-large
                 with seeded random weights, written as their published
                 formats and loaded through the native wrappers onto the card
                 (fp32, TF32 off); an instance tree at 480x640 (PNG bytes;
                 three instances of 20-32 frames, one too long, one too
                 short); select_frames.process_dataset with YOLOv8n and with
                 a paint detector (a stand-in for the trained gripper
                 weights), then trajectory.process_dataset_traj with RAFT
                 and SAM over the curated 14-frame instances; SAM called
                 directly with a point and a box and with 20 labelled points
                 (one encode for both).  Checks: the message counts; the card
                 against the port on the CPU (YOLO's 6,300 raw predictions,
                 SAM's embedding and mask, RAFT's flow for one pair) and one
                 instance's files and messages, within the bounds stated at
                 CURATION_BOUND; no K1-K4 launch.  Prints load, stage and
                 model times (CUDA events), one RAFT pair and one SAM encode
                 under torch.profiler (device ms, busy share, largest
                 kernels) and the peak memory

 11. tracking    (after phase 10, on its trees and its SAM) XMem-s012 (ResNet50
                 key encoder, ResNet18 value encoder, DEFAULT_CONFIG) and
                 FlowFormer sintel() (12 decoder iterations), seeded random,
                 written as a .pth and a flowformer_params_save .npz and
                 loaded through XMemPropagator and NativeFlowFormerFlow (fp32,
                 TF32 off); track_by_keypoint (a click, SAM, XMem, mask_N.png)
                 over a curated 14-frame instance; TrackingAnything.generator
                 over the 32-frame raw instance (every frame a memory frame,
                 long-term memory capped at 400: 5 consolidations, 2
                 evictions); one FlowFormer pair, then trajectory.main
                 --native-flowformer --sam over the curated instances; 3
                 xmem_trainer steps at batch 4 x 8 frames of 384x384, 2
                 objects; the painters on one tracked frame.  Checks: files,
                 shapes, messages; the card against the port on the CPU
                 within TRACKING_BOUND (XMem's key, selection and frame-1
                 probabilities, FlowFormer's flow, the first train step's
                 losses at batch 1 x 4 frames: 1e-4 relative; its AdamW
                 update to the formula within 1e-3 of lr, nonzero over the
                 parameters and the BN statistics; the 14 tracked masks and
                 the 32 generator masks by IoU 0.99, the generator's
                 consolidations and evictions equal) and, with TF32 on, the
                 XMem and FlowFormer comparisons beyond those bounds; no
                 K1-K4 launch.  Prints load, step and pair times (CUDA events), one
                 XMem step and one FlowFormer pair under torch.profiler, the
                 peak memory

Prints, before the last line, one JSON line with each kernel's launches
(summed over the paths of phases 5-11, each counted from zero), error, times and bound,
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
    fp16-variant tree with a tokenizer folder; returns each model's state as
    written (fp16 host copies, with the dtype of each original tensor)."""
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
    expected = {name: {k: (t.to(torch.float16).cpu(), t.dtype) for k, t in
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


def loaded_as_written(name, module, expected, dtype_of):
    """Check every tensor of ``module`` against the fp16 copy written for
    model ``name``, in ``dtype_of(key)`` (the dtype the loader gives it),
    bit for bit; returns the count of tensors checked."""
    got = module.state_dict()
    if set(got) != set(expected[name]):
        raise RuntimeError(f"{name}: loaded keys differ from the written ones")
    for k, (want16, _) in expected[name].items():
        want = want16.to(got[k].device).to(dtype_of(k))
        if got[k].dtype != want.dtype or not torch.equal(_bits(got[k]), _bits(want)):
            raise RuntimeError(f"{name}.{k} is not the fp16-rounded original in {want.dtype}")
    return len(got)


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
    n_tensors = sum(loaded_as_written(name, m, expected, lambda k: expected[name][k][1])
                    for name, m in loaded.items())
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


@contextlib.contextmanager
def first_batch(rec):
    """Keep a host copy of the first batch a train step of ``train_loop``
    receives in ``rec["first_batch"]``."""
    from this_and_that_vdm_tpu_torch.training import trainer

    saved = (trainer.make_vl_train_step, trainer.make_vgl_train_step)

    def wrap(make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(state, batch, *a, **kw):
                if "first_batch" not in rec:
                    rec["first_batch"] = {k: v.detach().cpu() for k, v in batch.items()}
                return step(state, batch, *a, **kw)

            return recorded

        return made

    trainer.make_vl_train_step, trainer.make_vgl_train_step = (wrap(m) for m in saved)
    try:
        yield rec
    finally:
        trainer.make_vl_train_step, trainer.make_vgl_train_step = saved


def phase_train(mode, config, steps, profile, smi, edits=None, args=("--synthetic", "4"),
                step0_check=None, batch_check=None, tag=None):
    """``train_loop.main`` on the shipped YAML (a temporary copy whose
    output_dir is a temporary directory, removed afterwards; ``edits`` sets
    other keys), ``steps`` steps of synthetic data (or what ``args`` says);
    the checks of phases 6 / 7 / 9.  With ``profile`` the last step runs
    under ``torch.profiler`` and is left out of the seconds per step.
    ``step0_check(models)`` and ``batch_check(first batch)`` add checks."""
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.training import train_loop

    tag = tag or f"train {mode}"
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{mode}_")
    try:
        edits = dict(edits or {}, output_dir=f"{tmp}/out")
        with open(config) as f:
            lines = [next((f"{k}: {v}" for k, v in edits.items() if line.startswith(f"{k}:")),
                          line) for line in f.read().splitlines()]
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
                if step0_check is not None:
                    rec["checks"]["loaded_tensors_as_written"] = step0_check(models)
                snap["trained"] = _snapshot(state.params)
                if mode == "vgl":
                    snap["unet"] = _snapshot(dict(models["unet"].named_parameters()))
                ops.reset_launch_counts()  # the main path's launches only
                torch.cuda.reset_peak_memory_stats()
                return
            rec["metrics"].append(dict(step=step, loss=float(m["loss"]),
                                       grad_norm=float(m["grad_norm"]),
                                       data_wait_s=m["data_wait_s"]))
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
        with timed_optimizer(opt_ms), first_batch(rec):
            train_loop.main(["--config", cfg_path, "--mode", mode, "--max-steps", str(steps)]
                            + list(args), on_step=on_step)
        wall = time.perf_counter() - t0
        if batch_check is not None:
            rec["checks"]["first_batch_as_written"] = batch_check(rec.pop("first_batch"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = rec["step_s"]
    timed = step_s[1:-1] if profile else step_s[1:]
    tf32 = dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)
    for m in rec["metrics"]:
        log(f"[{tag}] step {m['step']}: loss {m['loss']:.6f} grad_norm "
            f"{m['grad_norm']:.6f}; waited {m['data_wait_s']:.4f} s for the batch")
    prof = rec.get("profile")
    if prof is not None:
        prof.update(k2_bound_ms=gn_bound_ms(gn_sizes), k2_calls=len(gn_sizes),
                    k4_bound_ms=rec["k4_bound_ms"])
        log(f"[{tag}] profiled step {steps}: K4 {prof['kernels_ms']['adam8bit']:.3f} ms "
            f"device over {prof['kernel_launches']['adam8bit']} launches ({rec['leaves']} "
            f"leaves, bound {rec['k4_bound_ms']:.3f} ms); K2 {prof['kernels_ms']['groupnorm']:.3f}"
            f" ms device over {prof['kernel_launches']['groupnorm']} launches ({len(gn_sizes)} "
            f"calls, bound {prof['k2_bound_ms']:.3f} ms); optimizer update host ms by step "
            f"{[round(t, 3) for t in opt_ms]}  [{smi}]")
        log(f"[{tag}] profiled step {steps}: device {prof['total_ms']:.1f} ms of "
            f"{step_s[-1] * 1e3:.1f} ms wall; the port's kernels (ms) "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["kernels_ms"].items())
            + "; their launches in the step (by kernel name) "
            + ", ".join(f"{k} {v}" for k, v in prof["kernel_launches"].items())
            + "; largest: " + "; ".join(f"{n} {t:.2f}" for n, t in prof["top_ms"]))
    log(f"[{tag}] {steps} steps, seconds per step {[round(t, 4) for t in step_s]} "
        f"(timed steps >= 2: {[round(t, 4) for t in timed]}); peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes); TF32 {tf32}; 8-bit state over "
        f"{rec['state_params'] / 1e9:.4f} B parameters; launches {counts}; checks "
        f"{rec['checks']}; wall {wall:.1f} s  [{smi}]")
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
                 for m in rec["metrics"])
    if len(rec["metrics"]) != steps or not finite:
        raise RuntimeError(f"{tag}: metrics {rec['metrics']}")
    if not all(rec["checks"].values()):
        raise RuntimeError(f"{tag}: checks failed {rec['checks']}")
    if min(counts.values()) == 0:
        raise RuntimeError(f"{tag}: the training path skipped a kernel: {counts}")
    return dict(mode=mode, config=config, steps=steps, metrics=rec["metrics"],
                step_s=step_s, timed_step_s=timed, profile=prof, peak_bytes=peak, tf32=tf32,
                launches=counts, optimizer_host_ms=opt_ms,
                checks=rec["checks"], state_params=rec["state_params"], wall_s=wall)


# ----------------------------------------------------------------- phase 9

# Bridge-layout training data beside the weights: VGL instances of F frames,
# VL instances of 20-56 frames (subsample_indices takes real gaps), frames
# at the curated 480x640 as PNG bytes under the im_N.jpg names.  Every
# prompt says left or right, which turns the flip augmentation off, so the
# first batch compares with its source frames unflipped.
DATA = dict(vgl_frames=(F, F, F, F), vl_frames=(20, 31, 44, 56), seed=42, validation_step=3,
            vgl_steps=3, vl_steps=2, ab_steps=300, app_steps=4)
DATA_PROMPTS = ("push the cup to the left", "move the red block right",
                "slide the pot to the left", "turn the knob to the right")
DATA_GESTURES = ([(0, 320.0, 240.0)], [(0, 200.0, 150.0), (F - 1, 430.0, 300.0)])
LPIPS_REL_BOUND = 1e-4  # the card's LPIPS against the CPU's, TF32 off


def frame_seed(kind, inst, i):
    return 5000 + (500 if kind == "vl" else 0) + 100 * inst + i


def write_training_data(root, smi):
    """``<root>/data_vgl``, ``<root>/data_vl`` and ``<root>/val`` (phase 8's
    Instance0, for the validation render); returns their paths."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    t0 = time.perf_counter()
    paths = dict(vgl=os.path.join(root, "data_vgl"), vl=os.path.join(root, "data_vl"),
                 val=os.path.join(root, "val"))
    n_files, original = 0, ENTRY["original"]
    for kind, counts in (("vgl", DATA["vgl_frames"]), ("vl", DATA["vl_frames"])):
        for j, n in enumerate(counts):
            d = os.path.join(paths[kind], f"inst{j}")
            os.makedirs(d)
            for i in range(n):
                video_io.write_png(os.path.join(d, f"im_{i}.jpg"),
                                   instance_image(frame_seed(kind, j, i), original))
            with open(os.path.join(d, "lang.txt"), "w") as f:
                f.write(DATA_PROMPTS[j] + "\n")
            if kind == "vgl":
                with open(os.path.join(d, "data.txt"), "w") as f:
                    f.write("".join(f"{fr} {x} {y}\n" for fr, x, y in DATA_GESTURES[j % 2]))
            n_files += n
    shutil.copytree(os.path.join(root, "instances", "Instance0"),
                    os.path.join(paths["val"], "Instance0"))
    log(f"[weights+data] wrote {n_files} frames at {original[0]}x{original[1]} (PNG bytes) "
        f"in {time.perf_counter() - t0:.3f} s  [{smi}]")
    return paths


def first_batch_check(mode, tree, dims, smi):
    """The check of the first batch: the instance the seeded permutation puts
    first, its frames (subsampled in VL) as ``resize_bicubic`` of the source
    images written, its condition as the rasteriser makes it from its
    data.txt, its prompt ids as the tree's tokenizer gives them."""
    from this_and_that_vdm_tpu_torch.cli.tokenizer import CLIPTokenizer
    from this_and_that_vdm_tpu_torch.data.bridge import subsample_indices
    from this_and_that_vdm_tpu_torch.data.image import resize_bicubic
    from this_and_that_vdm_tpu_torch.data.rasterize import rasterize_gesture_points

    fr, h, w = dims
    counts = DATA["vgl_frames" if mode == "vgl" else "vl_frames"]
    first = int(np.random.RandomState(DATA["seed"]).permutation(len(counts))[0])
    idx = range(fr) if mode == "vgl" else subsample_indices(counts[first], fr)
    frames = np.stack([resize_bicubic(instance_image(frame_seed(mode, first, i),
                                                     ENTRY["original"]), h, w) for i in idx])
    want = dict(video_frames=frames.astype(np.float32) / 127.5 - 1.0,
                prompt_ids=CLIPTokenizer.from_pretrained(tree)([DATA_PROMPTS[first]])[0])
    if mode == "vgl":
        want["condition"] = rasterize_gesture_points(DATA_GESTURES[first % 2], ENTRY["original"],
                                                     (h, w), fr)

    def check(batch):
        same = {k: bool(np.array_equal(batch[k][0].numpy(), v)) for k, v in want.items()}
        same["motion_bucket_id"] = float(batch["motion_bucket_id"][0]) == 200.0
        log(f"[weights+data {mode}] first batch is instance inst{first} (frames "
            f"{list(idx)}): equal to its sources {same}  [{smi}]")
        return all(same.values())

    return check


def loaded_check(mode, expected, smi):
    """Step 0: every tensor of the five (VL: four) models equals the fp16
    copy written in phase 8, in the dtype it was loaded in: fp32 for the
    trainable model, the original's (bf16 weights, fp32 norms) for the
    frozen ones."""
    def check(models):
        n = 0
        for name, key in (("unet", "unet"), ("gesturenet", "controlnet"), ("vae", "vae"),
                          ("image_encoder", "image_encoder"), ("text_encoder", "text_encoder")):
            if models[key] is None:
                continue
            trainable = name == ("unet" if mode == "vl" else "gesturenet")
            n += loaded_as_written(name, models[key], expected,
                                   (lambda k: torch.float32) if trainable
                                   else (lambda k, name=name: expected[name][k][1]))
        log(f"[weights+data {mode}] step 0: {n} loaded tensors bit-equal to the fp16-rounded "
            f"originals (trainable fp32, frozen as written)  [{smi}]")
        return True

    return check


@contextlib.contextmanager
def probes(rec, keep_render):
    """Time ``load_training_models`` and ``render_validation`` as
    ``train_loop`` calls them (synchronised), with the render's own launch
    counts and the peak memory before it; copy the render to ``keep_render``
    before the run's output directory goes."""
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.training import validation
    from this_and_that_vdm_tpu_torch.weights import loader

    load, render = loader.load_training_models, validation.render_validation

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        sync()
        rec["load_s"] = time.perf_counter() - t0
        return out

    def timed_render(*args, **kwargs):
        sync()
        before, rec["train_peak"] = ops.launch_counts(), torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        out = render(*args, **kwargs)
        sync()
        rec["render_s"] = time.perf_counter() - t0
        rec["render_launches"] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        rec["render_dirs"] = [os.path.relpath(d, args[1]) for d in out]
        shutil.copytree(args[1], keep_render)
        return out

    loader.load_training_models, validation.render_validation = timed_load, timed_render
    try:
        yield rec
    finally:
        loader.load_training_models, validation.render_validation = load, render


def check_render(root, dirs, dims, smi):
    """The validation render: step_<validation_step>/Instance0 with one PNG a
    frame at the clip size, not constant, and a GIF of as many frames."""
    from this_and_that_vdm_tpu_torch.utils import video_io

    fr, h, w = dims
    want = os.path.join(f"step_{DATA['validation_step']}", "Instance0")
    frames = video_io.load_frames_dir(os.path.join(root, want))
    gif = gif_frames(os.path.join(root, want, "combined.gif"))
    ok = (dirs == [want] and len(frames) == fr and all(f.shape == (h, w, 3) for f in frames)
          and all(int(f.max()) > int(f.min()) for f in frames) and gif == (fr, w, h))
    log(f"[weights+data vgl] validation render {dirs}: {len(frames)} PNGs "
        f"{list(frames[0].shape) if frames else None}, GIF {gif}, per-frame range "
        f"{[(int(f.min()), int(f.max())) for f in frames[:3]]}...: ok {ok}  [{smi}]")
    if not ok:
        raise RuntimeError(f"weights+data: validation render {dirs} {len(frames)} {gif}")


def lpips_weights(path, seed=3):
    """Seeded AlexNet ``features`` and LPIPS heads in the nested layout."""
    from this_and_that_vdm_tpu_torch.utils.lpips import _ALEX_CONVS, CHANNELS

    gen = torch.Generator().manual_seed(seed)
    alex = {}
    for idx, cin, cout, k, _, _ in _ALEX_CONVS:
        alex[f"features.{idx}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.01
    lin = {f"lin{j}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen) * 0.1
           for j, c in enumerate(CHANNELS)}
    torch.save({"alexnet": alex, "lin": lin}, path)
    return alex, lin


def phase_eval_ab_app(tree, render_root, smi, device="cuda"):
    """cli.eval with LPIPS on the card (render against itself, against phase
    8's CLI render; the card's LPIPS against the CPU's), the 8-bit AdamW A/B
    (K4 on the card) and the app's one-shot from the tree.  Returns (report,
    launch counts of the A/B, of the app)."""
    from this_and_that_vdm_tpu_torch import app, ops
    from this_and_that_vdm_tpu_torch.cli import adam8bit_ab
    from this_and_that_vdm_tpu_torch.cli import eval as eval_cli
    from this_and_that_vdm_tpu_torch.utils import lpips, video_io

    rep = {}
    weights = os.path.join(tree, "lpips.pth")
    alex, lin = lpips_weights(weights)
    out = os.path.join(tree, "eval.json")
    rcs, reports = [], []
    for other, gate in ((render_root, ["--psnr-gate", "35"]), (os.path.join(tree, "rendered"),
                                                               [])):
        rcs.append(eval_cli.main([render_root, other, "--lpips-weights", weights, "--device",
                                  device, "--out", out] + gate))
        with open(out) as f:
            reports.append(json.load(f))
    self_lp = reports[0]["instances"]["Instance0"]["lpips_mean"]
    cli_lp = reports[1]["instances"]["Instance0"]["lpips_mean"]
    a = video_io.load_frames_dir(os.path.join(render_root, "Instance0"))
    b = video_io.load_frames_dir(os.path.join(tree, "rendered", "Instance0"))
    card = lpips.video_lpips(lpips.lpips_model(alex, lin, device), a, b)
    cpu = lpips.video_lpips(lpips.lpips_model(alex, lin, "cpu"), a, b)
    rel = abs(card - cpu) / abs(cpu)
    rep["eval"] = dict(rcs=rcs, gate_pass=reports[0].get("gate_pass"), lpips_self=self_lp,
                       lpips_vs_cli=cli_lp, psnr_vs_cli=reports[1]["instances"]["Instance0"][
                           "psnr_mean"], lpips_card=card, lpips_cpu=cpu, lpips_rel=rel)
    log(f"[eval] render vs itself: rc {rcs[0]}, gate {reports[0].get('gate_pass')}, LPIPS "
        f"{self_lp}; vs phase 8's CLI render: LPIPS {cli_lp}, PSNR "
        f"{rep['eval']['psnr_vs_cli']} dB; LPIPS on the card {card:.8f} vs CPU {cpu:.8f} "
        f"(rel {rel:.3e}, bound {LPIPS_REL_BOUND:.0e})  [{smi}]")
    if not (rcs[0] == 0 and reports[0].get("gate_pass") and self_lp < 1e-6 and cli_lp > 0
            and rel <= LPIPS_REL_BOUND):
        raise RuntimeError(f"eval: {rep['eval']}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    curves = adam8bit_ab.main(["--steps", str(DATA["ab_steps"]), "--device", device])
    ab_counts = ops.launch_counts()
    finals = {k: v[-1][1] for k, v in curves.items()}
    rep["ab"] = dict(final=finals, first={k: v[0][1] for k, v in curves.items()},
                     wall_s=time.perf_counter() - t0, launches=ab_counts)
    log(f"[a/b] {DATA['ab_steps']} steps in {rep['ab']['wall_s']:.2f} s: final loss fp32 "
        f"{finals['fp32']:.6f}, 8-bit {finals['adamw8bit']:.6f} (first "
        f"{rep['ab']['first']}); launches {ab_counts}  [{smi}]")
    for name, c in curves.items():
        v = [x for _, x in c]
        if not (np.all(np.isfinite(v)) and v[-1] < 0.5 * v[0]
                and sum(b < a for a, b in zip(v, v[1:])) >= 0.9 * (len(v) - 1)):
            raise RuntimeError(f"a/b: the {name} curve is not finite and decreasing: {c}")
    if ab_counts["adam8bit"] != DATA["ab_steps"]:
        raise RuntimeError(f"a/b: K4 launches {ab_counts}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    clip = app.main(["--pretrained", tree, "--image",
                     os.path.join(tree, "val", "Instance0", "im_0.jpg"), "--points", "320,240",
                     "430,300", "--steps", str(DATA["app_steps"]), "--prompt", PROMPTS[0],
                     "--device", device, "--out", os.path.join(tree, "demo.mp4")])
    app_counts = ops.launch_counts()
    rep["app"] = dict(path=os.path.basename(clip), bytes=os.path.getsize(clip),
                      wall_s=time.perf_counter() - t0, launches=app_counts)
    if clip.endswith(".gif"):
        rep["app"]["gif"] = gif_frames(clip)
    log(f"[app] one-shot from the tree, {DATA['app_steps']} steps: wrote {rep['app']}  [{smi}]")
    if rep["app"]["bytes"] < 1000 or rep["app"].get("gif", (F,))[0] != F:
        raise RuntimeError(f"app: {rep['app']}")
    if min(app_counts[k] for k in INFERENCE_KERNELS) == 0:
        raise RuntimeError(f"app: the path skipped a kernel: {app_counts}")
    return rep, ab_counts, app_counts


def phase_weights_and_data(tree, expected, smi):
    """Phase 9: train VGL (with a validation render) and VL from the phase-8
    tree on Bridge-layout data at full width; then eval, the A/B and the app.
    Returns (report, launch counts by path)."""
    paths = write_training_data(tree, smi)
    rep, launches = {}, {}
    for mode, config, steps in (("vgl", "config/train_image2video_gesturenet.yaml",
                                 DATA["vgl_steps"]),
                                ("vl", "config/train_image2video.yaml", DATA["vl_steps"])):
        edits = dict(dataset_path=f"[{paths[mode]}]", pretrained_tokenizer_name_or_path=tree)
        if mode == "vgl":
            edits.update(validation_img_folder=paths["val"],
                         validation_step=DATA["validation_step"])
        probe = {}
        with probes(probe, os.path.join(tree, "render_vgl")):
            run = phase_train(mode, config, steps, False, smi, edits=edits,
                              args=("--pretrained", tree),
                              step0_check=loaded_check(mode, expected, smi),
                              batch_check=first_batch_check(mode, tree, (F, H, W), smi),
                              tag=f"weights+data {mode}")
        run.update(probe)
        train_counts = {k: v - probe.get("render_launches", {}).get(k, 0)
                        for k, v in run["launches"].items()}
        launches[f"weights_data_{mode}"] = train_counts
        waits = [m["data_wait_s"] for m in run["metrics"]]
        log(f"[weights+data {mode}] load {probe['load_s']:.3f} s; first step "
            f"{run['step_s'][0]:.4f} s, later steps {[round(t, 4) for t in run['step_s'][1:]]} "
            f"s; loader wait per step {[round(t, 4) for t in waits]} s; peak "
            f"{run['peak_bytes'] / 2**30:.2f} GiB; train launches {train_counts}  [{smi}]")
        if min(train_counts.values()) == 0:
            raise RuntimeError(f"weights+data {mode}: the train path skipped a kernel "
                               f"{train_counts}")
        if mode == "vgl":
            launches["render"] = probe["render_launches"]
            log(f"[weights+data vgl] validation render {probe['render_s']:.3f} s; peak before "
                f"it {probe['train_peak'] / 2**30:.2f} GiB; render launches "
                f"{probe['render_launches']}  [{smi}]")
            if min(probe["render_launches"][k] for k in INFERENCE_KERNELS) == 0:
                raise RuntimeError(f"render skipped a kernel: {probe['render_launches']}")
            check_render(os.path.join(tree, "render_vgl"), probe["render_dirs"], (F, H, W), smi)
        rep[mode] = run
        torch.cuda.empty_cache()
    render_root = os.path.join(tree, "render_vgl", f"step_{DATA['validation_step']}")
    tools, launches["ab"], launches["app"] = phase_eval_ab_app(tree, render_root, smi)
    rep.update(tools)
    return rep, launches


# ----------------------------------------------------------------- phase 10

# The curation path at full width: SAM ViT-H, YOLOv8n with one class and
# RAFT-large (20 iterations), seeded random weights, fp32.  An instance tree
# as prepare_bridge leaves one (480x640 frames as PNG bytes under im_N.jpg,
# policy_out.pkl, lang.txt): three instances of 20-32 frames, one too long,
# one too short.  The scene paints the gripper magenta, moving (8, 4) px a
# frame; the gripper closes at frame 5 and opens 6 frames before the end.
CURATION = dict(frames=(20, 26, 32, 57, 10), hw=(480, 640), seed=77, raft_iters=20,
                box=(64, 48), start=(200, 200), step=(8, 4), close=5)
GRIPPER = (255, 0, 255)
# Bounds of phase 10: the card against the port on the CPU, the same weights
# and input, fp32 on both, TF32 off on the card; errors are the max abs error
# over the max abs CPU value.  The fp32 readings on an H100 (YOLO 1.1e-7, SAM
# 3.5e-6, RAFT 2.1e-6) sit far below the bounds; the bounds sit below what
# the same comparison reads on the card in a lower precision, which the phase
# measures every run as a negative control and requires to exceed them, so a
# precision slip fails: SAM and RAFT with TF32 on (10 mantissa bits; 9.1e-4
# and 6.1e-4 on an H100), YOLO in bf16 autocast (cuDNN keeps YOLOv8n's fp32
# convolutions on FFMA kernels with TF32 allowed: its TF32 reading equals the
# fp32 one, and is logged).
# - YOLO's raw predictions 1e-4, the box columns over their max and the
#   class scores over theirs (next to pixel boxes a score error would vanish):
#   ~60 convolutions that cuDNN and the CPU sum in other orders.
# - SAM's image embedding 1e-4: 32 ViT-H blocks; rounding differences grow
#   through the residual stream.
# - RAFT's flow 1e-4: 20 recurrent iterations feed each estimate back into
#   the correlation lookup, so each iteration's rounding compounds.
# - masks IoU >= 0.999: a mask thresholds logits at 0, and pixels whose logit
#   lies within the embedding's error of 0 may flip.  Held for the mask the
#   labeler writes, for a point and a box, and for 20 labelled points (the
#   trajectory stage's prompt: 24 slots).
# - traj_data.txt points within 1e-3 px: the chain truncates to whole
#   pixels, so the same start and flows within the bound give the same
#   points.  The CPU run picks its start from the card's SAM mask of that
#   frame: one flipped pixel shifts the order of the mask's pixels, and the
#   seeded pick then lands elsewhere (the mask itself is held by the IoU).
CURATION_BOUND = dict(yolo=1e-4, sam=1e-4, raft=1e-4, iou=0.999, px=1e-3)


@contextlib.contextmanager
def tf32_on():
    """TF32 for cuBLAS matmuls and cuDNN convolutions inside the block, off
    again after it (the wrappers turn it off)."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


class PaintDetector:
    """Stands in for the trained gripper weights (not in the repository):
    the xywh box of the gripper's paint, so the labeler's success path runs."""

    def boxes_xywh(self, image_bgr):
        ys, xs = np.nonzero((image_bgr == np.asarray(GRIPPER[::-1], np.uint8)).all(-1))
        if not len(xs):
            return np.zeros((0, 4), np.float32)
        x0, x1, y0, y1 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
        return np.array([[(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0]], np.float32)


class RecordingSegmenter:
    """The card's segmenter, keeping each labelled mask by its frame's bytes;
    ``replay`` serves them to another run."""

    def __init__(self, seg):
        self.seg, self.masks = seg, {}

    @staticmethod
    def key(image):
        import hashlib

        return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()

    def predict_mask_labeled(self, image_rgb, points, labels):
        mask = self.seg.predict_mask_labeled(image_rgb, points, labels)
        self.masks[self.key(image_rgb)] = mask
        return mask

    def replay(self):
        rec = self

        class Replay:
            def predict_mask_labeled(self, image_rgb, points, labels):
                return rec.masks[rec.key(image_rgb)]
        return Replay()


def curation_frame(bg, i):
    (x0, y0), (dx, dy), (w, h) = CURATION["start"], CURATION["step"], CURATION["box"]
    img = bg.copy()
    img[y0 + dy * i:y0 + dy * i + h, x0 + dx * i:x0 + dx * i + w] = GRIPPER
    return img


def write_curation_tree(root, smi):
    """The raw instance tree; returns the instance names."""
    import pickle

    from this_and_that_vdm_tpu_torch.utils import video_io

    t0 = time.perf_counter()
    names = []
    for j, n in enumerate(CURATION["frames"]):
        d = os.path.join(root, f"{j:06d}")
        os.makedirs(d)
        bg = instance_image(CURATION["seed"] + j, CURATION["hw"])
        for i in range(n):
            path = os.path.join(d, f"im_{i}.jpg")
            if 14 <= n <= 56 or i == 0:  # the others are refused before a frame is read
                video_io.write_png(path, curation_frame(bg, i))
            else:
                shutil.copyfile(os.path.join(d, "im_0.jpg"), path)
        closed = range(CURATION["close"], n - 6)
        with open(os.path.join(d, "policy_out.pkl"), "wb") as f:
            pickle.dump([{"actions": np.array([0.0] * 6 + [0.0 if i in closed else 1.0])}
                         for i in range(n)], f)
        with open(os.path.join(d, "lang.txt"), "w") as f:
            f.write(f"{DATA_PROMPTS[j % len(DATA_PROMPTS)]}\n")
        names.append(os.path.basename(d))
    log(f"[curation] wrote {len(names)} instances ({sum(CURATION['frames'])} frames at "
        f"{CURATION['hw'][0]}x{CURATION['hw'][1]}, PNG bytes) in "
        f"{time.perf_counter() - t0:.3f} s  [{smi}]")
    return names


def curation_checkpoints(root, smi):
    """Seeded random full-width models written as their published formats
    (a pickled fp16 detection model as ultralytics saves one, a SAM state
    dict, a RAFT state dict with the ``module.`` prefix); returns the paths."""
    from this_and_that_vdm_tpu_torch.models import raft, sam, yolov8
    from this_and_that_vdm_tpu_torch.weights.convert import save_ultralytics_checkpoint

    t0 = time.perf_counter()
    torch.manual_seed(CURATION["seed"])
    with torch.device("cuda"):
        y = yolov8.YOLOv8(yolov8.YOLOv8Config.n_scale(1))
        s = sam.Sam(sam.SamConfig.vit_h())
        r = raft.RAFT(raft.RAFTConfig.large())
    paths = {k: os.path.join(root, f) for k, f in (("yolo", "gripper.pt"),
                                                   ("sam", "sam.pth"), ("raft", "raft.pth"))}
    save_ultralytics_checkpoint(paths["yolo"], model=y)
    torch.save(s.state_dict(), paths["sam"])
    torch.save({f"module.{k}": v for k, v in r.state_dict().items()}, paths["raft"])
    n = {k: sum(p.numel() for p in m.parameters()) for k, m in (("yolo", y), ("sam", s),
                                                                 ("raft", r))}
    del y, s, r
    torch.cuda.empty_cache()
    log(f"[curation] built and wrote the models {n} params in "
        f"{time.perf_counter() - t0:.3f} s  [{smi}]")
    return paths, n


def yolo_err(got, want):
    """YOLO's error: the box columns (pixels) and the score columns (0-1),
    each over its own max abs CPU value."""
    return max(rel_err(got[:, :4], want[:, :4])[1], rel_err(got[:, 4:], want[:, 4:])[1])


def iou(a, b):
    """Intersection over union; 1.0 for two empty masks."""
    union = float((a | b).sum())
    return float((a & b).sum()) / union if union else 1.0


def read_mask(path):
    from this_and_that_vdm_tpu_torch.utils import video_io

    return video_io.read_png(path)[..., 0] > 127


def phase_curation(smi, root):
    """Phase 10: the This/That labeler and the flow-trajectory stage on the
    card at full width, against the port on the CPU, in ``root``.  Returns
    (report, launch counts of the phase, what phase 11 reuses: the trees,
    the card's SAM and its file)."""
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.curation import detectors, select_frames, trajectory
    from this_and_that_vdm_tpu_torch.models.raft import pad_to_multiple
    from this_and_that_vdm_tpu_torch.models.sam import preprocess_np, transform_coords_np
    from this_and_that_vdm_tpu_torch.models.yolov8 import letterbox_np
    from this_and_that_vdm_tpu_torch.utils.video_io import read_image

    t_phase = time.perf_counter()
    rep = {}
    raw = os.path.join(root, "raw")
    names = write_curation_tree(raw, smi)
    paths, rep["params"] = curation_checkpoints(root, smi)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    det = detectors.NativeGripperDetector(paths["yolo"], device="cuda")
    seg = detectors.NativeSAMSegmenter(paths["sam"], "vit_h", device="cuda")
    flow = detectors.NativeRAFTFlow(paths["raft"], iters=CURATION["raft_iters"],
                                    device="cuda")
    sync()
    rep["load_s"] = time.perf_counter() - t0
    log(f"[curation] loaded YOLOv8n, SAM ViT-H, RAFT-large from their files onto the card "
        f"in {rep['load_s']:.3f} s  [{smi}]")

    # the labeler with the detector's own weights (random: soft failures
    # expected), then with the paint detector, which curates the
    # instances the trajectory stage reads
    t0 = time.perf_counter()
    rep["select_yolo"] = select_frames.process_dataset(raw, os.path.join(root, "out_yolo"),
                                                       det, seg)
    sync()
    rep["select_yolo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    curated = os.path.join(root, "curated")
    rep["select"] = select_frames.process_dataset(raw, curated, PaintDetector(), seg)
    sync()
    rep["select_s"] = time.perf_counter() - t0
    log(f"[curation] select_frames with YOLOv8n: {rep['select_yolo']} in "
        f"{rep['select_yolo_s']:.3f} s; with the paint detector: {rep['select']} in "
        f"{rep['select_s']:.3f} s  [{smi}]")
    want = {"Success!": 3, "The number of frames is too long": 1,
            "The number of frames is too short": 1}
    if rep["select"] != want or sum(rep["select_yolo"].values()) != len(names):
        raise RuntimeError(f"select_frames: {rep['select']} / {rep['select_yolo']}")
    rec = RecordingSegmenter(seg)
    t0 = time.perf_counter()
    rep["traj"] = trajectory.process_dataset_traj(curated, flow_fn=flow, segmenter=rec)
    sync()
    rep["traj_s"] = time.perf_counter() - t0
    log(f"[curation] trajectory (RAFT + SAM) over {sum(want.values()) - 2} curated "
        f"instances: {rep['traj']} in {rep['traj_s']:.3f} s  [{smi}]")
    if sum(rep["traj"].values()) != 3:
        raise RuntimeError(f"trajectory: {rep['traj']}")

    # the full-width models called directly, whatever the messages, on the
    # frame whose mask the labeler makes (the CPU side encodes it too): a
    # point and a box, then 20 labelled points (24 slots), one encode
    src = os.path.join(raw, names[0])
    rgb = read_image(os.path.join(src, "im_0.jpg"))
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    point, box = [[232.0, 224.0]], [200.0, 200.0, 264.0, 248.0]
    pts20 = np.random.RandomState(5).rand(20, 2) * [640, 480]
    e0 = seg.encodes
    m1 = seg.predict_mask(bgr, point, box)
    m2 = seg.predict_mask_labeled(rgb, pts20, np.ones(20))
    rep["cache_encodes"] = seg.encodes - e0
    if m1.shape != CURATION["hw"] or m2.shape != CURATION["hw"] or rep["cache_encodes"] != 1:
        raise RuntimeError(f"SAM direct calls: {m1.shape} {m2.shape} encodes "
                           f"{rep['cache_encodes']}")
    rep["launches"] = ops.launch_counts()
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()

    # times on the card (CUDA events)
    dev = seg.device
    frames = [read_image(os.path.join(src, f"im_{i}.jpg")) for i in (0, 1)]
    with torch.no_grad():
        x = torch.from_numpy(preprocess_np(rgb, seg.cfg.img_size)[0]).to(dev)
        emb = seg.model.encode_image(x)
        pts = np.zeros((1, 24, 2), np.float32)
        pts[0, :20] = transform_coords_np(pts20, CURATION["hw"], seg.cfg.img_size)
        lbl = np.full((1, 24), -1, np.int64)
        lbl[0, :20] = 1
        pts, lbl = torch.from_numpy(pts).to(dev), torch.from_numpy(lbl).to(dev)
        xy = torch.from_numpy(np.ascontiguousarray(
            letterbox_np(bgr, det.imgsz)[0][None, ..., ::-1], np.float32) / 255.0).to(dev)
        f1, f2 = (torch.from_numpy(pad_to_multiple(f)[0][None].astype(np.float32)).to(dev)
                  for f in frames)
        rep["ms"] = dict(
            sam_encode=cuda_ms(lambda: seg.model.encode_image(x), iters=3),
            sam_predict_24_slots=cuda_ms(lambda: seg.model.predict(emb, pts, lbl)),
            yolo_frame=cuda_ms(lambda: det.model(xy)),
            raft_pair=cuda_ms(lambda: flow.model(f1, f2, iters=CURATION["raft_iters"]),
                              iters=3))
        # where the time goes: one RAFT pair and one SAM encode
        rep["profile"] = {k: profile_step(fn) for k, fn in (
            ("raft_pair", lambda: flow.model(f1, f2, iters=CURATION["raft_iters"])),
            ("sam_encode", lambda: seg.model.encode_image(x)))}
    log(f"[curation] card ms: {rep['ms']}; cache: {rep['cache_encodes']} encode for two "
        f"prompts on one frame; peak memory {rep['peak_bytes'] / 2**30:.2f} GiB; K1-K4 "
        f"launches {rep['launches']}  [{smi}]")
    for k, (dt, busy, span, wall) in rep["profile"].items():
        log(f"[curation] profile {k}: device {dt['total_ms']:.3f} ms in "
            f"{dt['activities']} activities, busy {busy:.3f} of a {span:.3f} ms span, "
            f"wall {wall:.3f} ms; largest {dt['top_ms'][:4]}  [{smi}]")

    # the card against the port on the CPU: one input each, the direct
    # SAM calls, then the files and messages of one instance of each stage
    t0 = time.perf_counter()
    cdet = detectors.NativeGripperDetector(paths["yolo"], device="cpu")
    cseg = detectors.NativeSAMSegmenter(paths["sam"], "vit_h", device="cpu")
    cflow = detectors.NativeRAFTFlow(paths["raft"], iters=CURATION["raft_iters"],
                                     device="cpu")
    err, err_tf32 = {}, {}
    want_yolo = torch.from_numpy(cdet.predict(bgr)[0])
    err["yolo"] = yolo_err(torch.from_numpy(det.predict(bgr)[0]), want_yolo)
    inst = names[0]
    out_cpu = os.path.join(root, "cpu", inst)
    msg_yolo = (select_frames.process_instance(src, os.path.join(root, "yolo_card"), det)[1],
                select_frames.process_instance(src, os.path.join(root, "yolo_cpu"), cdet)[1])
    ok, msg = select_frames.process_instance(src, out_cpu, PaintDetector(), cseg)
    seg.predict_mask(bgr, [[0.0, 0.0]])  # the card's embedding of the same frame
    want_emb = cseg._cache[0]
    err["sam"] = rel_err(seg._cache[0].cpu(), want_emb)[1]
    e0 = cseg.encodes
    err["iou_point_box"] = iou(m1, cseg.predict_mask(bgr, point, box))
    err["iou_20_points"] = iou(m2, cseg.predict_mask_labeled(rgb, pts20, np.ones(20)))
    rep["direct_mask_area"] = [float(m1.mean()), float(m2.mean())]
    if cseg.encodes != e0:
        raise RuntimeError("the CPU SAM encoded the labeler's frame twice")
    card_dir = os.path.join(curated, inst)
    for name in sorted(os.listdir(out_cpu)):
        if name.startswith("im_") or name in ("data.txt", "lang.txt"):
            with open(os.path.join(out_cpu, name), "rb") as a, \
                    open(os.path.join(card_dir, name), "rb") as b:
                if a.read() != b.read():
                    raise RuntimeError(f"curation: {inst}/{name} differs from the CPU's")
    err["mask_iou"] = iou(read_mask(os.path.join(out_cpu, "mask_0.png")),
                          read_mask(os.path.join(card_dir, "mask_0.png")))
    want_flow = torch.from_numpy(cflow(*frames))
    err["raft"] = rel_err(torch.from_numpy(flow(*frames)), want_flow)[1]
    # negative control: the same three comparisons with TF32 on the card,
    # and YOLO's in bf16
    with tf32_on(), torch.no_grad():
        err_tf32["yolo"] = yolo_err(torch.from_numpy(det.predict(bgr)[0]), want_yolo)
        err_tf32["sam"] = rel_err(seg.model.encode_image(x).cpu(), want_emb)[1]
        err_tf32["raft"] = rel_err(torch.from_numpy(flow(*frames)), want_flow)[1]
    with torch.autocast("cuda", torch.bfloat16):
        err_tf32["yolo_bf16"] = yolo_err(torch.from_numpy(det.predict(bgr)[0]), want_yolo)
    # the trajectory of an instance whose card run wrote traj_data.txt,
    # on the CPU from a copy of its curated folder
    traj_inst = next((n for n in names[:3]
                      if os.path.exists(os.path.join(curated, n, "traj_data.txt"))), None)
    if traj_inst is None:
        raise RuntimeError(f"trajectory: no instance wrote traj_data.txt: {rep['traj']}")
    traj_cpu = os.path.join(root, "traj_cpu")
    shutil.copytree(os.path.join(curated, traj_inst), traj_cpu,
                    ignore=shutil.ignore_patterns("traj_data.txt"))
    ok_t, msg_t = trajectory.generate_instance_traj(traj_cpu, flow_fn=cflow,
                                                    segmenter=rec.replay(),
                                                    rng=np.random.RandomState(0))
    rep["cpu_s"] = time.perf_counter() - t0
    pts_card = np.loadtxt(os.path.join(curated, traj_inst, "traj_data.txt"), ndmin=2)
    pts_cpu = np.loadtxt(os.path.join(traj_cpu, "traj_data.txt"), ndmin=2) if ok_t else None
    err["traj_px"] = (float(np.abs(pts_card - pts_cpu).max())
                      if pts_cpu is not None and pts_card.shape == pts_cpu.shape else None)
    rep["against_cpu"] = dict(err=err, err_tf32=err_tf32,
                              messages=dict(yolo=msg_yolo, select=msg, traj_instance=traj_inst,
                                            traj_points=len(pts_card), traj_cpu=msg_t))
    log(f"[curation] card against the CPU (bounds {CURATION_BOUND}): {err}; with TF32 on "
        f"and YOLO in bf16 (SAM, RAFT and yolo_bf16 must exceed the bounds) {err_tf32}; "
        f"direct mask areas "
        f"{rep['direct_mask_area']}; messages {rep['against_cpu']['messages']}; CPU side "
        f"{rep['cpu_s']:.3f} s  [{smi}]")
    b = CURATION_BOUND
    if (msg_yolo[0] != msg_yolo[1] or not ok or not ok_t
            or any(err[k] > b[k] for k in ("yolo", "sam", "raft"))
            or min(err["mask_iou"], err["iou_point_box"], err["iou_20_points"]) < b["iou"]
            or err["traj_px"] is None or err["traj_px"] > b["px"]):
        raise RuntimeError(f"curation: the card and the CPU disagree: {rep['against_cpu']}")
    if min(err_tf32["sam"] / b["sam"], err_tf32["raft"] / b["raft"],
           err_tf32["yolo_bf16"] / b["yolo"]) <= 1:
        raise RuntimeError(f"curation: a lower precision on the card stays within the fp32 "
                           f"bounds, so they cannot see a precision slip: {err_tf32}")
    if any(rep["launches"].values()):
        raise RuntimeError(f"curation launched K1-K4: {rep['launches']}")
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"[curation] phase wall {rep['wall_s']:.3f} s  [{smi}]")
    return rep, rep["launches"], dict(raw=raw, curated=curated, names=names, seg=seg,
                                      sam=paths["sam"], sam_type="vit_h")


# ----------------------------------------------------------------- phase 11
#
# Tracking, FlowFormer and the XMem trainer at full width: XMem-s012 (ResNet50
# key encoder, ResNet18 value encoder) with DEFAULT_CONFIG as written, and
# FlowFormer sintel() with its 12 decoder iterations, both seeded random and
# written in their own file formats.  The 32-frame generator run makes every
# frame a memory frame and caps long-term memory at 400 elements: with
# mem_every 5 a 32-frame clip writes 7 memory frames, fewer than
# max_mid_term_frames (10), so nothing would consolidate; this way 32 frames
# consolidate 5 times and evict twice (1,200 tokens a frame at 480x640).
TRACKING = dict(seed=91, clip_frames=32, label=3, click=(232, 224),
                generator_config=dict(mem_every=1, max_long_term_elements=400),
                train=dict(batch=4, frames=8, hw=(384, 384), objects=2, steps=3),
                check=dict(batch=1, frames=4))
# Bounds of phase 11: the card against the port on the CPU (same weights and
# input, fp32 on both, TF32 off on the card); errors are the max abs error
# over the max abs CPU value.  Each sits between the fp32 reading and the
# reading with TF32 on, which the phase measures every run and requires to
# exceed it (the readings are in PERF.md).
# - XMem's key and selection 1e-4: ResNet50 through layer3 and a 3x3 conv.
# - XMem's frame-1 probabilities 1e-4: both encoders, the memory readout and
#   the decoder.
# - FlowFormer's flow 1e-4: 12 recurrent iterations feed each estimate back
#   into the cost lookup, as RAFT's 20 do in phase 10.
# - the first train step's losses and gradient norm 1e-4 relative: 4 frames,
#   batch 1, at draws that are fixed (3 reference frames, deep update 1).
# - that step's AdamW update on each side 1e-3 of the learning rate from the
#   formula on the side's own gradient, over the parameters and the batch
#   norms' statistics (fp32 rounds a leaf of magnitude up to 2 to 1.2e-7,
#   1.2e-4 of lr 1e-3; an update left undone misses by 1); the change over
#   each must be nonzero.  The two sides' updates are not compared with each
#   other: for |g| near eps, g / (|g| + eps) turns last-bit gradient
#   differences into differences of order lr.
# - the masks of the 14-frame clip and of the 32-frame generator run (which
#   consolidates and evicts) IoU >= 0.99 a frame: a mask thresholds
#   probabilities at 0.5, and usage accumulates frame by frame.
TRACKING_BOUND = dict(key=1e-4, selection=1e-4, prob=1e-4, flow=1e-4, loss=1e-4, update=1e-3,
                      iou=0.99)


def xmem_checkpoint(path, seed):
    """Seeded random XMem-s012 weights written as a ``.pth`` state dict
    under the published names: weights at 1/sqrt(fan-in), batch norms with
    nontrivial statistics (the default init's identity norms and shrinking
    activations would track nothing)."""
    from this_and_that_vdm_tpu_torch.models.xmem import XMem

    with torch.device("meta"):
        names = XMem().state_dict()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in names.items():
        shape = tuple(v.shape)
        if not v.is_floating_point():
            sd[k] = torch.zeros(shape, dtype=torch.long)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(shape, generator=g) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = torch.randn(shape, generator=g) * 0.3
        elif len(shape) == 1 and k.endswith("weight"):
            sd[k] = torch.rand(shape, generator=g) + 0.5
        elif len(shape) <= 1:
            sd[k] = torch.randn(shape, generator=g) * 0.1
        else:
            sd[k] = torch.randn(shape, generator=g) / float(np.prod(shape[1:])) ** 0.5
    torch.save(sd, path)
    return sum(t.numel() for t in sd.values() if t.is_floating_point())


def flowformer_archive(path, seed):
    """A seeded random FlowFormer sintel() in the ``.npz`` format of
    ``flowformer_params_save`` (GMA's gamma set to 0.5, so the global motion
    term counts)."""
    from this_and_that_vdm_tpu_torch.models import flowformer

    torch.manual_seed(seed)
    model = flowformer.FlowFormer(flowformer.FlowFormerConfig.sintel())
    with torch.no_grad():
        model.update_block.gma.gamma.fill_(0.5)
    flowformer.save_flowformer(path, model)
    return sum(p.numel() for p in model.parameters())


def train_batch(b, t, hw, n, seed, device):
    """A synthetic XMem training batch: ImageNet-normalised noise frames,
    each object a moving rectangle, cls_gt their index map."""
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    rgb = torch.randn(b, t, h, w, 3, generator=g) * 0.8
    cls_gt = torch.zeros(b, t, h, w, dtype=torch.long)
    for bi in range(b):
        for o in range(n):
            y = int(torch.randint(0, h // 2, (), generator=g))
            x = int(torch.randint(0, w // 2, (), generator=g))
            for ti in range(t):
                y1, x1 = y + 4 * ti, x + 4 * ti
                cls_gt[bi, ti, y1:y1 + h // 3, x1:x1 + w // 3] = o + 1
    gt0 = torch.stack([(cls_gt[:, 0] == o + 1).float() for o in range(n)], 1)
    return {k: v.to(device) for k, v in dict(
        rgb=rgb, first_frame_gt=gt0, cls_gt=cls_gt, selector=torch.ones(b, n),
        num_objects=torch.full((b,), n, dtype=torch.long)).items()}


class FirstMask:
    """The card's segmenter, keeping the mask it makes (the CPU side reuses
    it, as phase 10 replays SAM's masks)."""

    def __init__(self, seg):
        self.seg, self.mask = seg, None

    def predict_mask(self, image_bgr, points_xy, box_xyxy=None):
        self.mask = self.seg.predict_mask(image_bgr, points_xy, box_xyxy)
        return self.mask


def counting(obj, name, counter, key, shrinks=None):
    """Wrap ``obj.name`` to count its calls in ``counter[key]`` (with
    ``shrinks``, only the calls after which ``shrinks()`` got smaller)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        before = shrinks() if shrinks else None
        out = fn(*args, **kwargs)
        counter[key] += 1 if shrinks is None or shrinks() < before else 0
        return out
    setattr(obj, name, wrapped)


def xmem_readings(model, frames, first_mask):
    """Key, selection (frame 0) and the frame-1 probabilities of one model,
    on the host."""
    from this_and_that_vdm_tpu_torch.curation import xmem_tracker as xt
    from this_and_that_vdm_tpu_torch.models.xmem import normalize_imagenet

    dev = next(model.parameters()).device
    x = normalize_imagenet(torch.from_numpy(frames[0].astype(np.float32) / 255.0))
    x = torch.from_numpy(xt.pad_divide_by(x.numpy(), 16)[0]).permute(2, 0, 1)[None].to(dev)
    core = xt.XMemInferenceCore(model, xt.DEFAULT_CONFIG)
    core.set_all_labels([1])
    with torch.no_grad():
        key, _, selection = model.encode_key(x)[:3]
        core.step(frames[0].astype(np.float32) / 255.0, first_mask[None].astype(np.float32))
        prob = core.step(frames[1].astype(np.float32) / 255.0)
    return dict(key=key.cpu(), selection=selection.cpu(), prob=prob.cpu())


def step_readings(model, batch, cfg):
    """One train step's losses and gradient norm, and its AdamW update held
    to the formula on the step's own gradient, ``p - lr (g / (|g| + eps) +
    wd p)`` from zero moments: ``update_err`` is the largest miss over lr,
    over every trained leaf (the frozen batch norms' statistics among them,
    which the step trains as JAX's does).  Also the norms of the change over
    the parameters and over the statistics, and how many gradient elements
    lie under 1e-6, where ``g / (|g| + eps)`` is not yet ``sign(g)``."""
    from this_and_that_vdm_tpu_torch.training import xmem_trainer as xt

    opt = xt.make_optimizer(model, cfg)
    params = set(map(id, model.parameters()))
    leaves = [t for group in opt.param_groups for t in group["params"]]
    before = [t.detach().double() for t in leaves]
    losses = xt.train_step(model, opt, batch, 0, cfg, torch.Generator().manual_seed(0))
    out = {k: float(v) for k, v in losses.items()}
    lr, wd = cfg.learning_rate, cfg.weight_decay
    out.update(update_err=0.0, small_grads=0)
    sq = {True: 0.0, False: 0.0}
    for t, p0 in zip(leaves, before):
        g, p1 = t.grad.double(), t.detach().double()
        expect = p0 - lr * (g / (g.abs() + 1e-8) + wd * p0)
        out["update_err"] = max(out["update_err"], float((p1 - expect).abs().max()) / lr)
        out["small_grads"] += int((g.abs() < 1e-6).sum())
        sq[id(t) in params] += float((p1 - p0).square().sum())
    out.update(update_norm=sq[True] ** 0.5, bn_update_norm=sq[False] ** 0.5)
    return out


def phase_tracking(smi, root, ctx):
    """Phase 11: click-to-mask tracking (SAM + XMem), FlowFormer in the
    trajectory stage, the XMem trainer and the painters on the card at full
    width, against the port on the CPU.  Reuses phase 10's trees and SAM.
    Returns (report, launch counts of the phase)."""
    from this_and_that_vdm_tpu_torch import ops
    from this_and_that_vdm_tpu_torch.curation import (detectors, painters, tracking,
                                                      trajectory, xmem_tracker)
    from this_and_that_vdm_tpu_torch.models.flowformer import flowformer_forward
    from this_and_that_vdm_tpu_torch.models.raft import pad_to_multiple
    from this_and_that_vdm_tpu_torch.training import xmem_trainer
    from this_and_that_vdm_tpu_torch.utils.video_io import read_image

    t_phase = time.perf_counter()
    rep = {}
    t0 = time.perf_counter()
    paths = {"xmem": os.path.join(root, "XMem-s012.pth"),
             "flowformer": os.path.join(root, "flowformer_sintel.npz")}
    rep["params"] = dict(xmem=xmem_checkpoint(paths["xmem"], TRACKING["seed"]),
                         flowformer=flowformer_archive(paths["flowformer"], TRACKING["seed"]))
    log(f"[tracking] wrote XMem-s012 (.pth) and FlowFormer sintel (.npz) {rep['params']} "
        f"params in {time.perf_counter() - t0:.3f} s  [{smi}]")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prop = tracking.XMemPropagator(paths["xmem"], device="cuda")
    sync()
    rep["load_xmem_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flow = detectors.NativeFlowFormerFlow(paths["flowformer"], device="cuda")
    sync()
    rep["load_flowformer_s"] = time.perf_counter() - t0
    if flow.iters != 12:
        raise RuntimeError(f"FlowFormer sintel runs {flow.iters} iterations, not 12")
    log(f"[tracking] loaded XMem-s012 in {rep['load_xmem_s']:.3f} s and FlowFormer sintel in "
        f"{rep['load_flowformer_s']:.3f} s onto the card  [{smi}]")

    # 1. click -> SAM -> XMem -> mask_N.png on a curated 14-frame instance
    inst = os.path.join(ctx["curated"], sorted(os.listdir(ctx["curated"]))[0])
    n_frames = len([f for f in os.listdir(inst) if f.startswith("im_")])
    first = FirstMask(ctx["seg"])
    out = os.path.join(root, "tracked")
    t0 = time.perf_counter()
    masks = tracking.track_by_keypoint(inst, first, propagator=prop, store_dir=out,
                                       device="cuda")
    sync()
    rep["track_s"] = time.perf_counter() - t0
    files = sorted(os.listdir(out))
    written = [read_mask(os.path.join(out, f"mask_{i}.png")) for i in range(len(masks))]
    if (len(masks) != n_frames or len(files) != n_frames
            or any(w.shape != CURATION["hw"] or not np.array_equal(w, m)
                   for w, m in zip(written, masks))):
        raise RuntimeError(f"track_by_keypoint: {len(masks)} masks, files {files}")
    rep["mask_area"] = [float(m.mean()) for m in masks]
    log(f"[tracking] track_by_keypoint (SAM + XMem, DEFAULT_CONFIG) over {n_frames} frames at "
        f"{CURATION['hw'][0]}x{CURATION['hw'][1]} in {rep['track_s']:.3f} s; mask areas "
        f"{[round(a, 4) for a in rep['mask_area']]}  [{smi}]")

    # 2. TrackingAnything over the 32-frame raw instance: consolidation, eviction
    src = os.path.join(ctx["raw"], ctx["names"][2])
    clip = [read_image(os.path.join(src, f"im_{i}.jpg")) for i in range(TRACKING["clip_frames"])]
    cfg = dict(xmem_tracker.DEFAULT_CONFIG, **TRACKING["generator_config"])
    ta = tracking.TrackingAnything(ctx["seg"], prop.model, cfg, device="cuda")
    click_mask, _, click_painted = ta.first_frame_click(clip[0], np.array([TRACKING["click"]]))
    (x0, y0), (bw, bh) = CURATION["start"], CURATION["box"]
    template = np.zeros(CURATION["hw"], np.uint8)
    template[y0:y0 + bh, x0:x0 + bw] = TRACKING["label"]  # the gripper's paint at frame 0
    mem = ta.tracker.core.memory
    events = dict(consolidations=0, evictions=0)
    counting(mem, "compress_features", events, "consolidations")
    counting(mem.long_mem, "remove_obsolete_features", events, "evictions",
             lambda: mem.long_mem.size)
    t0 = time.perf_counter()
    gen_masks, _, gen_painted = ta.generator(clip, template)
    sync()
    rep["generator_s"] = time.perf_counter() - t0
    rep["generator"] = dict(events, long_term=mem.long_mem.size, working=mem.work_mem.size,
                            area=[float((m == TRACKING["label"]).mean()) for m in gen_masks[::8]])
    if (len(gen_masks) != len(clip) or any(set(np.unique(m)) - {0, TRACKING["label"]}
                                           for m in gen_masks)
            or events["consolidations"] < 1 or events["evictions"] < 1
            or click_mask.shape != CURATION["hw"] or click_painted.shape != clip[0].shape
            or gen_painted[-1].shape != clip[0].shape):
        raise RuntimeError(f"TrackingAnything: {rep['generator']}")
    log(f"[tracking] TrackingAnything.generator over {len(clip)} frames ({cfg}) in "
        f"{rep['generator_s']:.3f} s: {rep['generator']}  [{smi}]")

    # 3. FlowFormer: one pair, then the trajectory CLI over the curated tree
    pair = [read_image(os.path.join(inst, f"im_{i}.jpg")) for i in (0, 1)]
    t0 = time.perf_counter()
    flow_card = flow(*pair)
    sync()
    rep["flow_pair_s"] = time.perf_counter() - t0
    traj_root = os.path.join(root, "traj_flowformer")
    shutil.copytree(ctx["curated"], traj_root,
                    ignore=shutil.ignore_patterns("traj_data.txt"))
    t0 = time.perf_counter()
    rep["traj"] = trajectory.main([traj_root, "--native-flowformer", paths["flowformer"],
                                   "--sam", ctx["sam"], "--sam-type", ctx["sam_type"]])
    sync()
    rep["traj_s"] = time.perf_counter() - t0
    n_curated = len(os.listdir(ctx["curated"]))
    traj_files = [n for n in os.listdir(traj_root)
                  if os.path.exists(os.path.join(traj_root, n, "traj_data.txt"))]
    points = [np.loadtxt(os.path.join(traj_root, n, "traj_data.txt"), ndmin=2)
              for n in traj_files]  # "frame x y" lines
    if (sum(rep["traj"].values()) != n_curated or flow_card.shape != CURATION["hw"] + (2,)
            or len(traj_files) != rep["traj"].get("Success!", 0)
            or any(p.shape != (14, 3) or not np.array_equal(p[:, 0], np.arange(14))
                   for p in points)):
        raise RuntimeError(f"trajectory --native-flowformer: {rep['traj']}, files {traj_files}")
    log(f"[tracking] FlowFormer pair {rep['flow_pair_s']:.3f} s; trajectory --native-flowformer "
        f"--sam over {n_curated} curated instances: {rep['traj']} in {rep['traj_s']:.3f} s  "
        f"[{smi}]")

    # 4. the XMem trainer: 3 steps with the config's draws
    tcfg = TRACKING["train"]
    xcfg = xmem_trainer.XMemTrainConfig()
    rep["peak_bytes_tracking"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b = tcfg["batch"]
    model = tracking.load_xmem(paths["xmem"], "cuda").train()
    opt = xmem_trainer.make_optimizer(model, xcfg)
    gen = torch.Generator().manual_seed(TRACKING["seed"])
    steps = []
    for it in range(tcfg["steps"]):
        batch = train_batch(b, tcfg["frames"], tcfg["hw"], tcfg["objects"],
                            TRACKING["seed"] + it, "cuda")
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        marks[0].record()
        losses = xmem_trainer.train_step(model, opt, batch, it, xcfg, gen)
        marks[1].record()
        sync()
        steps.append(dict({k: float(v) for k, v in losses.items()},
                          s=time.perf_counter() - t0, ms=marks[0].elapsed_time(marks[1])))
    rep["train"] = dict(batch=b, frames=tcfg["frames"], hw=tcfg["hw"], steps=steps,
                        peak_bytes=torch.cuda.max_memory_allocated())
    del model, opt, batch
    torch.cuda.empty_cache()
    if any(not np.isfinite(s["total_loss"]) or not s["grad_norm"] > 0 for s in steps):
        raise RuntimeError(f"xmem_trainer: {steps}")
    readings = [(s["total_loss"], s["grad_norm"], s["s"]) for s in steps]
    log(f"[tracking] xmem_trainer {tcfg['steps']} steps, batch {b} x {tcfg['frames']} frames at "
        f"{tcfg['hw'][0]}x{tcfg['hw'][1]}, {tcfg['objects']} objects: {readings} (loss, grad "
        f"norm, s); peak {rep['train']['peak_bytes'] / 2**30:.2f} GiB  [{smi}]")

    # 5. the painters on one tracked frame
    frame, m = pair[1], masks[1]
    overlay = painters.mask_painter(frame, m)
    band = painters.mask_contour(m)
    dots = painters.point_painter(overlay, [TRACKING["click"]], point_radius=8)
    colour = painters.flow_to_image(flow_card)
    if (overlay.shape != frame.shape or dots.shape != frame.shape
            or colour.shape != frame.shape or colour.dtype != np.uint8
            or band.shape != m.shape or (m.any() and not band.any())
            or (m.any() and np.array_equal(overlay, frame))):
        raise RuntimeError("painters: wrong overlay")
    rep["painters"] = dict(mask_px=int(m.sum()), band_px=int(band.sum()),
                           changed_px=int((overlay != frame).any(-1).sum()))
    rep["launches"] = ops.launch_counts()

    # times on the card (CUDA events) and where the time goes
    core = xmem_tracker.XMemInferenceCore(prop.model, xmem_tracker.DEFAULT_CONFIG)
    core.set_all_labels([1])
    img01 = [f.astype(np.float32) / 255.0 for f in pair]
    core.step(img01[0], masks[0][None].astype(np.float32))
    x1, x2 = (torch.from_numpy(pad_to_multiple(f)[0][None].astype(np.float32)).cuda()
              for f in pair)
    with torch.no_grad():
        rep["ms"] = dict(xmem_step=cuda_ms(lambda: core.step(img01[1])),
                         flowformer_pair=cuda_ms(lambda: flowformer_forward(flow.model, x1, x2),
                                                 iters=3),
                         train_step=float(np.mean([s["ms"] for s in steps[1:]])))
        rep["profile"] = {k: profile_step(fn) for k, fn in (
            ("xmem_step", lambda: core.step(img01[1])),
            ("flowformer_pair", lambda: flowformer_forward(flow.model, x1, x2)))}
    rep["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[tracking] card ms: {rep['ms']} (train_step: steps 2-3); peak memory "
        f"{rep['peak_bytes_tracking'] / 2**30:.2f} GiB tracking, "
        f"{rep['train']['peak_bytes'] / 2**30:.2f} GiB training; K1-K4 launches "
        f"{rep['launches']}  [{smi}]")
    for k, (dt, busy, span, wall) in rep["profile"].items():
        log(f"[tracking] profile {k}: device {dt['total_ms']:.3f} ms in {dt['activities']} "
            f"activities, busy {busy:.3f} of a {span:.3f} ms span, wall {wall:.3f} ms; "
            f"largest {dt['top_ms'][:4]}  [{smi}]")

    # the card against the port on the CPU
    t0 = time.perf_counter()
    frames = [read_image(os.path.join(inst, f"im_{i}.jpg")) for i in range(n_frames)]
    cpu_model = tracking.load_xmem(paths["xmem"], "cpu")
    want = xmem_readings(cpu_model, frames, first.mask)
    got = xmem_readings(prop.model, frames, first.mask)
    err = {k: rel_err(got[k], want[k])[1] for k in ("key", "selection", "prob")}
    cpu_masks = xmem_tracker.xmem_propagator(cpu_model)(frames, first.mask)
    ious = [iou(a, b) for a, b in zip(masks, cpu_masks)]
    err["iou_min"] = min(ious)
    # the 32-frame generator run, consolidations and evictions included
    cpu_ta = tracking.TrackingAnything(ctx["seg"], cpu_model, cfg, device="cpu")
    cpu_mem = cpu_ta.tracker.core.memory
    gen_cpu_events = dict(consolidations=0, evictions=0)
    counting(cpu_mem, "compress_features", gen_cpu_events, "consolidations")
    counting(cpu_mem.long_mem, "remove_obsolete_features", gen_cpu_events, "evictions",
             lambda: cpu_mem.long_mem.size)
    label = TRACKING["label"]
    gen_ious = [iou(a == label, b == label)
                for a, b in zip(gen_masks, cpu_ta.generator(clip, template)[0])]
    err["iou_min_generator"] = min(gen_ious)
    cflow = detectors.NativeFlowFormerFlow(paths["flowformer"], device="cpu")
    want_flow = torch.from_numpy(cflow(*pair))
    err["flow"] = rel_err(torch.from_numpy(flow_card), want_flow)[1]
    ccfg = xmem_trainer.XMemTrainConfig(num_ref_frames=TRACKING["check"]["frames"] - 1,
                                        deep_update_prob=1.0, learning_rate=1e-3)
    cb = train_batch(TRACKING["check"]["batch"], TRACKING["check"]["frames"], tcfg["hw"],
                     tcfg["objects"], TRACKING["seed"], "cpu")
    want_step = step_readings(tracking.load_xmem(paths["xmem"], "cpu").train(), cb, ccfg)
    got_step = step_readings(tracking.load_xmem(paths["xmem"], "cuda").train(),
                             {k: v.cuda() for k, v in cb.items()}, ccfg)
    err["loss"] = max(abs(got_step[k] - want_step[k]) / abs(want_step[k])
                      for k in ("total_loss", "ce_loss", "dice_loss", "grad_norm"))
    err["update"] = max(got_step["update_err"], want_step["update_err"])
    # negative control: the same comparisons with TF32 on the card
    err_tf32 = {}
    with tf32_on():
        got32 = xmem_readings(prop.model, frames, first.mask)
        err_tf32.update({k: rel_err(got32[k], want[k])[1] for k in ("key", "selection", "prob")})
        err_tf32["flow"] = rel_err(torch.from_numpy(flow(*pair)), want_flow)[1]
    rep["cpu_s"] = time.perf_counter() - t0
    rep["against_cpu"] = dict(err=err, err_tf32=err_tf32, ious=ious, generator_ious=gen_ious,
                              generator_events_cpu=gen_cpu_events, step_card=got_step,
                              step_cpu=want_step)
    log(f"[tracking] card against the CPU (bounds {TRACKING_BOUND}): {err}; with TF32 on (each "
        f"must exceed its bound) {err_tf32}; mask IoU a frame {[round(x, 5) for x in ious]}; "
        f"generator mask IoU a frame {[round(x, 5) for x in gen_ious]}, CPU memory events "
        f"{gen_cpu_events}; first step card {got_step} CPU {want_step}; CPU side "
        f"{rep['cpu_s']:.3f} s  [{smi}]")
    b = TRACKING_BOUND
    if (any(err[k] > b[k] for k in ("key", "selection", "prob", "flow", "loss", "update"))
            or min(err["iou_min"], err["iou_min_generator"]) < b["iou"]
            or not min(got_step["update_norm"], got_step["bn_update_norm"]) > 0
            or gen_cpu_events != events):
        raise RuntimeError(f"tracking: the card and the CPU disagree: {rep['against_cpu']}")
    if min(err_tf32[k] / b[k] for k in err_tf32) <= 1:
        raise RuntimeError(f"tracking: TF32 on the card stays within the fp32 bounds, so they "
                           f"cannot see a precision slip: {err_tf32}")
    if any(rep["launches"].values()):
        raise RuntimeError(f"tracking launched K1-K4: {rep['launches']}")
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"[tracking] phase wall {rep['wall_s']:.3f} s  [{smi}]")
    return rep, rep["launches"]


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
        for path, c in (("serve", serve_counts), ("cli", cli_counts)):
            if min(c[k] for k in INFERENCE_KERNELS) == 0:
                raise RuntimeError(f"the {path} path skipped a kernel: {c}")
        weights_data, wd_counts = phase_weights_and_data(tree, expected, smi)
    finally:
        expected = None
        shutil.rmtree(tree, ignore_errors=True)
    torch.cuda.empty_cache()
    train = [phase_train(*args, smi) for args in TRAIN_CONFIGS]
    torch.cuda.empty_cache()
    curation_root = tempfile.mkdtemp(prefix="chip_smoke_curation_")
    try:
        curation, curation_counts, ctx = phase_curation(smi, curation_root)
        tracking, tracking_counts = phase_tracking(smi, curation_root, ctx)
    finally:
        ctx = None
        shutil.rmtree(curation_root, ignore_errors=True)
    paths = dict(slice=counts, serve=serve_counts, cli=cli_counts, **wd_counts,
                 **{f"train_{t['mode']}": t["launches"] for t in train},
                 curation=curation_counts, tracking=tracking_counts)

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
                       weights_and_data=weights_data, curation=curation, tracking=tracking,
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
