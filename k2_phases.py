"""Where one K2 (GroupNorm) launch spends its time, on one CUDA card.

    python3 k2_phases.py

Builds a copy of ``csrc/groupnorm.cu`` into ``build/k2_phases/`` in which
thread 0 of every block stamps the card's global timer (ns) at each phase
boundary, runs the kernel at a few main-path shapes, and prints, in
microseconds from the first block's start, the latest (and earliest) block
at: bulk copies issued, first data landed, first segment folded, statistics
published (before the grid barrier), barrier passed, combine done, output
written.  The kernel's arithmetic is untouched; the stamps add a global
store a phase.  Prints one line per shape, then all of them as one JSON
object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "this_and_that_vdm_tpu_torch", "csrc", "groupnorm.cu")
OUT = os.path.join(ROOT, "build", "k2_phases")
PHASES = ("start", "issued", "first data", "first fold", "published", "barrier", "combined",
          "written")
SHAPES = [((28, 1536, 320), torch.bfloat16, True), ((2, 21504, 320), torch.bfloat16, True),
          ((28, 384, 640), torch.bfloat16, True), ((28, 96, 1280), torch.bfloat16, True),
          ((28, 24, 1280), torch.bfloat16, True), ((28, 1536, 640), torch.bfloat16, True),
          ((14, 1536, 320), torch.float32, True)]

# (anchor in the kernel source, stamp inserted after it)
_STAMPS = [
    ("gn_coop(const GnArgs a) {", "\n  STAMP(0);"),
    ("        bulk_load(slab + (size_t)c0 * C, x + ((size_t)r0 + c0) * C, bytes, &bars[j]);\n"
     "      }\n    }\n  }", "\n  STAMP(1);"),
    ("      hop::mbar_wait(&bars[j], 0);", "\n      if (pos == r0) STAMP(2);"),
    ("    pos = end;\n    if (end != seg_end) continue;", "\n    if (seg == 0) STAMP(3);"),
    ("  // ---- every block's partial sums are published", "\n  STAMP(4);"),
    ("  cg::this_grid().sync();", "\n  STAMP(5);"),
]


def instrumented() -> str:
    src = open(SRC).read()
    for f in ("common.cuh", "hopper.cuh"):
        src = src.replace(f'#include "{f}"', f'#include "{os.path.join(os.path.dirname(SRC), f)}"')
    src = src.replace("namespace {\n", '''__device__ unsigned long long g_stamps[2048 * 8];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t; \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); g_stamps[blockIdx.x * 8 + (i)] = t; } \\
  } while (0)
namespace {
''', 1)
    for anchor, stamp in _STAMPS:
        if anchor not in src:
            raise RuntimeError(f"k2_phases: anchor not found in groupnorm.cu: {anchor!r}")
        src = src.replace(anchor, anchor + stamp, 1)
    combined = "  __syncthreads();\n\n  // ---- apply, segment by segment"
    launch = "int launch(const GnArgs& a"
    for anchor in (combined, launch):
        if anchor not in src:
            raise RuntimeError(f"k2_phases: anchor not found in groupnorm.cu: {anchor!r}")
    src = src.replace(combined, "  __syncthreads();\n  STAMP(6);\n\n  // ---- apply, segment by segment", 1)
    # the kernel's closing brace: the last one before the launcher's template line
    end = src.rindex("}\n", 0, src.rindex("template", 0, src.index(launch)))
    src = src[:end] + "  __syncthreads();\n  STAMP(7);\n" + src[end:]
    return src + '''
extern "C" int k2_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(unsigned long long) * 2048 * 8);
}
extern "C" int k2_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(unsigned long long) * 2048 * 8);
}
'''


def build():
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "groupnorm_stamped.cu"), os.path.join(OUT, "groupnorm_stamped.so")
    open(cu, "w").write(instrumented())
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    from this_and_that_vdm_tpu_torch.ops import _native

    lib.ttv_groupnorm.argtypes = _native._SIGNATURES["ttv_groupnorm"]
    lib.k2_stamps.argtypes = [ctypes.c_void_p]
    lib.k2_clear.argtypes = []
    return lib


def main():
    import chip_smoke as cs
    from this_and_that_vdm_tpu_torch.ops import groupnorm as gn

    smi = cs.phase_device()
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for shape, dtype, silu in SHAPES:
        n, s, c = shape
        x = cs._randn(shape, dtype, 4, 2.0, 0.5)
        w, b = cs._randn((c,), torch.float32, 5, 0.1, 1.0), cs._randn((c,), torch.float32, 6, 0.1)
        p = gn.plan(n, s, c, 32, x.element_size(), sms)
        part = torch.empty((p.grid * p.kmax * 64,), device="cuda")
        y = torch.empty_like(x)
        stamps = np.zeros(2048 * 8, np.uint64)
        for i in range(5):  # the last call's stamps are kept
            if i == 4:
                cs.sync()
                lib.k2_clear()
            err = lib.ttv_groupnorm(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                    part.data_ptr(), n * s, s, c, 32, 1e-6, int(silu),
                                    p.rows_per_block, p.kmax, p.grid, int(p.resident), p.smem,
                                    int(dtype == torch.bfloat16),
                                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k2_phases: launch error {err}")
        cs.sync()
        if cs.rel_err(y, gn._plain(x, w, b, 32, 1e-6, silu))[1] >= cs.BOUND[dtype]:
            raise RuntimeError(f"k2_phases {shape}: the stamped kernel disagrees with the plain one")
        lib.k2_stamps(stamps.ctypes.data)
        raw = stamps.reshape(2048, 8)[:p.grid].astype(np.int64)
        t = (raw - raw[:, 0].min()) / 1e3
        seen = [i for i in range(8) if (raw[:, i] > 0).all()]  # the streamed route has no copies
        row = dict(shape=list(shape), dtype=str(dtype), route="resident" if p.resident else "streamed",
                   grid=p.grid, us={PHASES[i]: [float(t[:, i].max()), float(t[:, i].min())]
                                    for i in seen})
        rows.append(row)
        cs.log(f"[k2 phases] {shape} {str(dtype)[6:]} {row['route']:8s} grid {p.grid}: "
               + "; ".join(f"{k} {v[0]:.2f} ({v[1]:.2f})" for k, v in row["us"].items())
               + f"  [{smi}]")
    cs.log(json.dumps(dict(card=smi, phases_us_latest_earliest=rows)))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
