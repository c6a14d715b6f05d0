// K2: GroupNorm (+ optional SiLU) over a folded [N, S, C] tensor, for Hopper.
//
// Replaces this_and_that_vdm_tpu/ops/groupnorm_pallas.py::_kernel (launched by
// _gn_pallas).  The TPU kernel holds one whole [S, C] batch row in VMEM and
// reads it once.  Here the whole tensor is split into contiguous slabs of
// rows (positions), one slab per block, and the statistics of a (row, group)
// that spans several slabs meet across one grid barrier: the kernel is one
// cooperative launch (every block resident at once), in one of two routes
// that the wrapper picks by shape before the launch (ops/groupnorm.py plan):
//
//   resident  the tensor fits in the card's shared memory (132 x 227 KB, up to
//             ~28 MB: [28, 1536, 320] bf16 and [14, 1536, 320] fp32 included).
//             One block an SM; each copies its slab into shared memory with
//             1-D bulk copies (TMA) in up to 8 chunks of at least 16 KB, each
//             completing on its own mbarrier, and reduces each chunk as it
//             lands.  The tensor is
//             read once and written once, as on the TPU.
//   streamed  everything larger (the 55-83 MB skip-concat sites, the VAE
//             decoder's [8, 98304, 128]).  Two blocks an SM; the slab is read
//             from device memory for the statistics and again, in reverse
//             order (its tail is still in L2), for the output.
//
// Phases, both routes:
//   reduce   a thread owns 16-byte pieces of the row (8 bf16 or 4 fp32
//            channels) at a fixed channel offset and walks the slab's rows
//            with the threads owning the other pieces, keeping fp32 sums and
//            sums of squares per channel in registers.  At the end of each
//            batch row's part of the slab (a segment) the block folds them
//            through shared memory, a warp a group over its (row walker,
//            channel) partials and a shuffle tree, in a fixed order (no
//            atomics), and
//            writes one (sum, sum of squares) per group to its own slot of
//            the scratch: part[block][segment][G].  The wrapper allocates the
//            scratch with torch.empty; every slot that is read was written.
//   barrier  one grid-wide barrier (cooperative_groups grid sync).
//   combine  for every segment at once, a team of lanes per (segment, group)
//            sums the slots of every block that holds part of that batch row,
//            in block order, with a fixed shuffle tree: every block gets the
//            same bits, and every team loads at once (one trip to L2).
//            Mean and rsqrt of the variance (one-pass moments, clamped >= 0),
//            then the thread's per-channel scale and shift (gamma and beta
//            were read into registers while the slab loaded), in registers.
//   apply    y = x * w[c] + b[c], optional SiLU, from shared memory (resident)
//            or device memory (streamed), written once in the input dtype.
//
// Bound: bytes.  One read and one write of the tensor: at [28, 1536, 320]
// bf16, 55.1 MB, 16.4 us at 3.35 TB/s.  The streamed route reads twice.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 16;   // channels a thread owns: C <= 16 * THREADS = 4096
constexpr int CHUNKS = 8;   // bulk copies (and mbarriers) per resident slab
constexpr int GPW = 4;      // groups a warp folds side by side (G = 32 over 8 warps)
constexpr int BATCH = 8;    // partial-sum slots a lane of the combine loads at once
constexpr int MAX_C = SLOTS * THREADS;

struct GnArgs {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  float* part;  // [grid][kmax][G] (sum, sum of squares)
  int rows;     // N * S
  int S, C, G;
  int rpb;      // rows a block
  int kmax;     // segments a block at most
  float eps;
  int silu;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(hop::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

// fp32 registers -> 16 bytes
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  ttv::store8(p, v);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 16 raw bytes, read-only through the non-coherent path from device memory
// (the streamed route: x is not written by this kernel) or from shared memory
template <bool GLOBAL>
__device__ __forceinline__ uint4 ld16(const void* p) {
  return GLOBAL ? __ldg(reinterpret_cast<const uint4*>(p)) : *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}

// x * sigmoid(x): fp32 through ex2 and a fast reciprocal; bf16 through one
// tanh.approx (x/2 (1 + tanh(x/2)), relative error ~2^-11, far below the bf16
// rounding that follows), half the special-function work
template <typename T>
__device__ __forceinline__ float silu(float v);
template <>
__device__ __forceinline__ float silu<float>(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}
template <>
__device__ __forceinline__ float silu<__nv_bfloat16>(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
  return fmaf(0.5f * v, t, 0.5f * v);
}

// KP: 16-byte pieces of a row a thread owns, 1 while a row has at most
// THREADS pieces (C <= 2048 bf16, 1024 fp32: every site but the 2560-wide
// ones), else SLOTS / VEC; fewer pieces leave registers for more rows in flight
template <typename T, bool RESIDENT, int KP>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 1 : 2) gn_coop(const GnArgs a) {
  constexpr int VEC = 16 / sizeof(T);  // channels a piece
  constexpr int NV = KP * VEC;         // channels a thread owns
  // rows whose pieces a thread has in flight at once (raw registers:
  // UNROLL * KP * 4 <= 32)
  constexpr int UNROLL = (RESIDENT ? 4 : 8) / KP;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[CHUNKS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, C = a.C, G = a.G, cpg = a.C / a.G;
  const int pieces = C / VEC, lanes = min(pieces, THREADS), rif = THREADS / lanes;
  const int rsub = tid / lanes, p0 = tid % lanes;
  const bool active = rsub < rif;
  const int r0 = blockIdx.x * a.rpb, r1 = min(a.rows, r0 + a.rpb);
  const int n0 = r0 / S, nseg = (r1 - 1) / S - n0 + 1;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  T* slab = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + (RESIDENT ? (size_t)a.rpb * C * sizeof(T) : 0));
  float* red2 = red + rif * C;
  float* stat = red2 + rif * C;  // [kmax][G] (mean, rstd)
  // chunks of at least 16 KB (a small slab lands in one or two)
  const int chunks = max(1, min(CHUNKS, (int)((size_t)(r1 - r0) * C * sizeof(T) / 16384)));
  const int crows = (r1 - r0 + chunks - 1) / chunks;

  if (RESIDENT) {
    if (tid == 0) {
      for (int j = 0; j < CHUNKS; ++j) hop::mbar_init(&bars[j], 1);
      hop::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < chunks && j * crows < r1 - r0; ++j) {
        const int c0 = j * crows, c1 = min(r1 - r0, c0 + crows);
        const uint32_t bytes = (uint32_t)(c1 - c0) * C * sizeof(T);
        hop::mbar_expect_tx(&bars[j], bytes);
        bulk_load(slab + (size_t)c0 * C, x + ((size_t)r0 + c0) * C, bytes, &bars[j]);
      }
    }
  }
  // the thread's gamma and beta, read while the slab streams in
  float gam[NV], bet[NV];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = min((p0 + k * lanes) * VEC + j, C - 1);
      gam[k * VEC + j] = a.gamma[c];
      bet[k * VEC + j] = a.beta[c];
    }
  }

  // ---- reduce: per-channel sums in registers, folded per segment
  float s1[NV], s2[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) s1[i] = s2[i] = 0.f;
  int seg = 0;
  for (int pos = r0; pos < r1;) {
    const int seg_end = min(r1, (pos / S + 1) * S);
    int end = seg_end;
    if (RESIDENT) {
      const int j = (pos - r0) / crows;
      end = min(end, r0 + (j + 1) * crows);
      hop::mbar_wait(&bars[j], 0);
    }
    if (active) {
      for (int r = pos + rsub; r < end; r += UNROLL * rif) {
        uint4 raw[UNROLL][KP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            const int rr = r + u * rif, p = p0 + k * lanes;
            if (rr < end && p < pieces)
              raw[u][k] = ld16<!RESIDENT>(RESIDENT ? slab + (size_t)(rr - r0) * C + p * VEC
                                                   : x + (size_t)rr * C + p * VEC);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            if (r + u * rif < end && p0 + k * lanes < pieces) {
              float v[VEC];
              unpack(raw[u][k], v);
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                s1[k * VEC + j] += v[j];
                s2[k * VEC + j] = fmaf(v[j], v[j], s2[k * VEC + j]);
              }
            }
          }
        }
      }
    }
    pos = end;
    if (end != seg_end) continue;
    // fold the segment: each group's (row walker, channel) partials in a
    // fixed order, a warp a group, lanes over them, then a shuffle tree
    if (active) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int p = p0 + k * lanes;
        if (p < pieces) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            red[rsub * C + p * VEC + j] = s1[k * VEC + j];
            red2[rsub * C + p * VEC + j] = s2[k * VEC + j];
            s1[k * VEC + j] = s2[k * VEC + j] = 0.f;
          }
        }
      }
    }
    __syncthreads();
    // a warp takes GPW groups side by side, so their loads and shuffle trees
    // overlap instead of running one group after another
    for (int g0 = warp; g0 < G; g0 += GPW * (THREADS / 32)) {
      float t1[GPW], t2[GPW];
#pragma unroll
      for (int q = 0; q < GPW; ++q) {
        const int g = g0 + q * (THREADS / 32);
        t1[q] = t2[q] = 0.f;
        for (int e = lane; g < G && e < rif * cpg; e += 32) {
          const int i = (e / cpg) * C + g * cpg + e % cpg;
          t1[q] += red[i];
          t2[q] += red2[i];
        }
      }
#pragma unroll
      for (int sh = 16; sh; sh >>= 1) {
#pragma unroll
        for (int q = 0; q < GPW; ++q) {
          t1[q] += __shfl_xor_sync(0xffffffffu, t1[q], sh);
          t2[q] += __shfl_xor_sync(0xffffffffu, t2[q], sh);
        }
      }
#pragma unroll
      for (int q = 0; q < GPW; ++q) {
        const int g = g0 + q * (THREADS / 32);
        if (lane == 0 && g < G)
          reinterpret_cast<float2*>(a.part)[((size_t)blockIdx.x * a.kmax + seg) * G + g] =
              make_float2(t1[q], t2[q]);
      }
    }
    __syncthreads();
    ++seg;
  }

  // ---- every block's partial sums are published
  cg::this_grid().sync();

  // ---- combine: the statistics of every segment.  A team of L lanes (a
  // power of two, 32 / L teams a warp) a (segment, group): its lanes sum the
  // slots of the blocks holding part of that batch row, in block order, then
  // a fixed shuffle tree; every block gets the same bits.  All teams load at
  // once, so the step costs one trip to L2, not one a group.
  const float2* part = reinterpret_cast<const float2*>(a.part);
  const float count = (float)S * (float)cpg;
  const int units = nseg * G;
  int L = 32;  // from kmax, not nseg: every block sums a group in the same order
  while (L > 1 && a.kmax * G * L > THREADS) L >>= 1;
  for (int u0 = 0; u0 < units; u0 += THREADS / L) {
    const int u = u0 + tid / L, l = tid % L;
    float t1 = 0.f, t2 = 0.f;
    if (u < units) {
      const int k = u / G, g = u % G, n = n0 + k;
      const int b_lo = (int)((long long)n * S / a.rpb);
      const int b_hi = (int)(((long long)n * S + S - 1) / a.rpb);
      // up to BATCH slots a lane loaded at once, then summed in block order
      for (int b0 = b_lo + l; b0 <= b_hi; b0 += BATCH * L) {
        float2 v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          const int b = b0 + i * L;
          v[i] = b <= b_hi ? part[((size_t)b * a.kmax + n - (int)((long long)b * a.rpb / S)) * G + g]
                           : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          t1 += v[i].x;
          t2 += v[i].y;
        }
      }
    }
    for (int sh = L / 2; sh; sh >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, sh);
      t2 += __shfl_xor_sync(0xffffffffu, t2, sh);
    }
    if (u < units && l == 0) {
      const float mean = t1 / count;
      // one-pass variance cancels slightly negative on (near-)constant groups
      const float var = fmaxf(t2 / count - mean * mean, 0.f);
      stat[2 * u] = mean;
      stat[2 * u + 1] = rsqrtf(var + a.eps);
    }
  }
  __syncthreads();

  // ---- apply, segment by segment (streamed: last first, its tail is in L2)
  for (int i = 0; i < nseg; ++i) {
    const int k = RESIDENT ? i : nseg - 1 - i;
    const int n = n0 + k;
    const int a0 = max(r0, n * S), a1 = min(r1, (n + 1) * S);
    float w[NV], sh[NV];
#pragma unroll
    for (int k2 = 0; k2 < KP; ++k2) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int c = min((p0 + k2 * lanes) * VEC + j, C - 1);
        const float* st = stat + 2 * (k * G + c / cpg);
        w[k2 * VEC + j] = st[1] * gam[k2 * VEC + j];
        sh[k2 * VEC + j] = bet[k2 * VEC + j] - st[0] * w[k2 * VEC + j];
      }
    }
    if (active) {
      for (int q = rsub; q < a1 - a0; q += UNROLL * rif) {
        uint4 raw[UNROLL][KP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int qq = q + u * rif, r = RESIDENT ? a0 + qq : a1 - 1 - qq;
#pragma unroll
          for (int k2 = 0; k2 < KP; ++k2) {
            const int p = p0 + k2 * lanes;
            if (qq < a1 - a0 && p < pieces)
              raw[u][k2] = ld16<!RESIDENT>(RESIDENT ? slab + (size_t)(r - r0) * C + p * VEC
                                                    : x + (size_t)r * C + p * VEC);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int qq = q + u * rif, r = RESIDENT ? a0 + qq : a1 - 1 - qq;
#pragma unroll
          for (int k2 = 0; k2 < KP; ++k2) {
            const int p = p0 + k2 * lanes;
            if (qq < a1 - a0 && p < pieces) {
              float v[VEC];
              unpack(raw[u][k2], v);
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                v[j] = fmaf(v[j], w[k2 * VEC + j], sh[k2 * VEC + j]);
                if (a.silu) v[j] = silu<T>(v[j]);
              }
              store16(y + (size_t)r * C + p * VEC, v);
            }
          }
        }
      }
    }
  }
}

template <typename T, bool RESIDENT, int KP>
int launch(const GnArgs& a, int grid, int smem, cudaStream_t st) {
  static ttv::PerDevice allowed;  // dynamic shared memory each device allows
  auto fn = gn_coop<T, RESIDENT, KP>;
  const cudaError_t ea = ttv::allow_smem(reinterpret_cast<const void*>(fn), smem, allowed);
  if (ea != cudaSuccess) return (int)ea;
  void* args[] = {const_cast<GnArgs*>(&a)};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless every block is resident
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                                    dim3(grid), dim3(THREADS), args,
                                                    (size_t)smem, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int dispatch(const GnArgs& a, int grid, int resident, int smem, cudaStream_t st) {
  constexpr int WIDE = SLOTS * sizeof(T) / 16;  // pieces a thread, up to C = 4096
  const bool one = a.C / (16 / (int)sizeof(T)) <= THREADS;
  if (resident)
    return one ? launch<T, true, 1>(a, grid, smem, st) : launch<T, true, WIDE>(a, grid, smem, st);
  return one ? launch<T, false, 1>(a, grid, smem, st) : launch<T, false, WIDE>(a, grid, smem, st);
}

}  // namespace

// x, y [rows = N * S, C] (bf16 or fp32, 16-byte aligned); gamma, beta [C]
// fp32; part >= grid * kmax * G * 2 floats.  grid, rows_per_block, kmax,
// resident and smem come from the wrapper's plan (ops/groupnorm.py).
extern "C" int ttv_groupnorm(const void* x, const void* gamma, const void* beta, void* y,
                             void* part, int rows, int S, int C, int G, float eps, int silu,
                             int rows_per_block, int kmax, int grid, int resident, int smem,
                             int is_bf16, void* stream) {
  if (C > MAX_C || G < 1 || C % G || C % 8 || S < 1 || rows % S || rows_per_block < 1 ||
      grid < 1 || (long long)grid * rows_per_block < rows ||
      (long long)(grid - 1) * rows_per_block >= rows || kmax < 1)
    return (int)cudaErrorInvalidValue;
  const GnArgs a{x, y, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                 static_cast<float*>(part), rows, S, C, G, rows_per_block, kmax, eps, silu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, grid, resident, smem, st)
                 : dispatch<float>(a, grid, resident, smem, st);
}
