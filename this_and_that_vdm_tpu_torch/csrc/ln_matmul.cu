// K3: LayerNorm -> matmul (+ bias), for Hopper (sm_90a).
//
// Replaces this_and_that_vdm_tpu/ops/ln_matmul.py::_kernel (launched by
// _ln_matmul_pallas_local).  On the TPU the grid walks the column blocks of
// one row block in order, so the normalised [BR, C] rows are computed once
// into a VMEM scratch and reused.  On the card blocks run in no order and
// share nothing, so the work splits in two launches:
//
//   ln_stats   one warp per row: fp32 mean, then the variance of the centred
//              row (two passes, as jnp.mean / jnp.var), into a per-row
//              [R, 2] (mean, rstd) buffer -- 8 bytes a row.
//   ln_matmul  one block per 128 x 128 output tile (8 warps, each 64 x 32).
//              It walks C in chunks of 32: each thread fetches its 16-byte
//              pieces of the x and weight chunks into registers one chunk
//              ahead, normalises the x piece with the row's stats and the
//              affine, rounds it to bf16 and stores both into the other half
//              of a double-buffered shared-memory stage -- the counterpart of
//              the TPU's xn_ref, a chunk at a time, so any C fits.  Products
//              run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//              fp32 accumulate in registers); the fp32 bias is added in the
//              epilogue, which leaves in 16-byte stores.  The normalised
//              tensor never goes to device memory.
//
// fp32 inputs take a simpler kernel (64 x 64 tiles, per-block statistics,
// plain FMAs) so that fp32 stays full fp32; it is the comparison path, not
// the bf16 main path.
//
// Weight layout: w is the nn.Linear weight [N, C] (out, in), read as the
// column-major [C, N] operand; bias is fp32 [N].  Rows past R and columns
// past N are masked; C % 8 == 0 and 16-byte-aligned x and w (the wrapper
// checks both).
//
// Bound at the slice's shapes: R=43008, C=320, N=960 (qkv) is 26 GFLOP
// against ~110 MB -- compute-bound; C=1280, N=10240 at R=2688 is 70 GFLOP.
// mma.sync without wgmma, TMA or a deeper pipeline leaves most of the tensor
// cores' rate on the table; those are later work.
#include <stdint.h>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ------------------------------------------------------------ bf16 path

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDS = BK + 8;  // shared row stride (elements): 80 bytes, 16-byte aligned
constexpr int STAGE = BM * LDS;  // elements of one A (or B) stage

__global__ void __launch_bounds__(256)
    ln_stats(const bf16* __restrict__ x, float2* __restrict__ stats, int R, int C,
             float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= R) return;
  const bf16* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(v[j]);
  }
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / C;
  float q = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(v[j]) - mean;
      q = fmaf(d, d, q);
    }
  }
  for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(q / C + eps));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: {a0, a1, a2, a3} = rows {g, g+8, g, g+8}, cols {2t, 2t, 2t+8, 2t+8} (+0, +1)
//   B 16x8:  {b0, b1} = rows {2t, 2t+8} (+0, +1), col g
//   C 16x8:  {c0, c1} = row g, cols 2t, 2t+1;  {c2, c3} = row g+8
// With an 80-byte shared row stride the 32-bit fragment loads of the 8 rows
// x 4 words a load touches fall in 32 distinct banks.
__global__ void __launch_bounds__(THREADS, 2)  // <= 128 registers: two blocks per SM
    ln_matmul_bf16(const bf16* __restrict__ x, const float2* __restrict__ stats,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const bf16* __restrict__ w, const float* __restrict__ wb,
                   bf16* __restrict__ out, int R, int C, int N, int has_bias) {
  __shared__ __align__(128) bf16 smem[4 * STAGE];  // A0, A1, B0, B1: 40 KB
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // each thread moves 2 16-byte pieces of A and of B per chunk: piece
  // p = tid + i*256 -> tile row p / 4, columns pcol .. pcol + 8 of the chunk
  const int pcol = (tid & 3) * 8;
  int prow[2];
  float2 st[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    prow[i] = (tid + i * THREADS) >> 2;
    const int row = m0 + prow[i];
    st[i] = row < R ? stats[row] : make_float2(0.f, 0.f);
  }
  uint4 ra[2], rb[2];
  float4 rg[2], rbe[2];  // gamma and beta of the thread's 8 columns
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto fetch = [&](int k0) {
    const int c = k0 + pcol;
    if (c < C) {
      rg[0] = *reinterpret_cast<const float4*>(gamma + c);
      rg[1] = *reinterpret_cast<const float4*>(gamma + c + 4);
      rbe[0] = *reinterpret_cast<const float4*>(beta + c);
      rbe[1] = *reinterpret_cast<const float4*>(beta + c + 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + prow[i], col = n0 + prow[i];
      ra[i] = (row < R && c < C) ? *reinterpret_cast<const uint4*>(x + (size_t)row * C + c)
                                 : zero;
      rb[i] = (col < N && c < C) ? *reinterpret_cast<const uint4*>(w + (size_t)col * C + c)
                                 : zero;
    }
  };
  auto put = [&](int stage, int k0) {
    bf16* sA = smem + stage * STAGE;
    bf16* sB = smem + (2 + stage) * STAGE;
    const float gm[8] = {rg[0].x, rg[0].y, rg[0].z, rg[0].w, rg[1].x, rg[1].y, rg[1].z, rg[1].w};
    const float bt[8] = {rbe[0].x, rbe[0].y, rbe[0].z, rbe[0].w,
                         rbe[1].x, rbe[1].y, rbe[1].z, rbe[1].w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 na = zero;
      if (k0 + pcol < C) {
        const bf16* v = reinterpret_cast<const bf16*>(&ra[i]);
        bf16* o = reinterpret_cast<bf16*>(&na);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = __float2bfloat16(fmaf((__bfloat162float(v[j]) - st[i].x) * st[i].y, gm[j], bt[j]));
      }
      *reinterpret_cast<uint4*>(sA + prow[i] * LDS + pcol) = na;
      *reinterpret_cast<uint4*>(sB + prow[i] * LDS + pcol) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (C + BK - 1) / BK;
  fetch(0);
  put(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * BK);  // in flight during the products
    const bf16* sA = smem + cur * STAGE + (wm * 64 + g) * LDS + 2 * t;
    const bf16* sB = smem + (2 + cur) * STAGE + (wn * 32 + g) * LDS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* pa = sA + i * 16 * LDS + kk;
        a[i][0] = ld32(pa);
        a[i][1] = ld32(pa + 8 * LDS);
        a[i][2] = ld32(pa + 8);
        a[i][3] = ld32(pa + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* pb = sB + j * 8 * LDS + kk;
        b[j][0] = ld32(pb);
        b[j][1] = ld32(pb + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    // the other stage was last read in iteration kt-1, before its barrier
    if (kt + 1 < nk) put(cur ^ 1, (kt + 1) * BK);
    __syncthreads();
  }

  // epilogue: each 16 x 32 row band of the warp tile goes through a per-warp
  // fp32 staging tile (reusing the stages), then out in 16-byte stores
  constexpr int LT = 32 + 4;
  float* tile = reinterpret_cast<float*>(smem) + warp * 16 * LT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tile[g * LT + j * 8 + 2 * t] = acc[i][j][0];
      tile[g * LT + j * 8 + 2 * t + 1] = acc[i][j][1];
      tile[(g + 8) * LT + j * 8 + 2 * t] = acc[i][j][2];
      tile[(g + 8) * LT + j * 8 + 2 * t + 1] = acc[i][j][3];
    }
    __syncwarp();
    const int rr = lane >> 1, cc = (lane & 1) * 16;
    const int row = m0 + wm * 64 + i * 16 + rr;
    if (row < R) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col0 = n0 + wn * 32 + cc + h * 8;
        bf16* dst = out + (size_t)row * N + col0;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = tile[rr * LT + cc + h * 8 + e] + (has_bias && col0 + e < N ? wb[col0 + e] : 0.f);
        if (col0 + 8 <= N && (N & 7) == 0) {
          ttv::store8(dst, v);
        } else {
          for (int e = 0; e < 8 && col0 + e < N; ++e) dst[e] = __float2bfloat16(v[e]);
        }
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ fp32 path

constexpr int FM = 64, FN = 64, FK = 32, FTHREADS = 128;
constexpr int FLD = FK + 4;

__global__ void __launch_bounds__(FTHREADS)
    ln_matmul_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ w,
                  const float* __restrict__ wb, float* __restrict__ out, int R, int C, int N,
                  float eps, int has_bias) {
  __shared__ float sa[FM * FLD], sb[FN * FLD], mean_s[FM], rstd_s[FM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  for (int r = warp; r < FM; r += FTHREADS / 32) {  // per-row stats, one warp per row
    const int row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < R) {
      const float* xr = x + (size_t)row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += xr[c];
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      mean = s / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) q = fmaf(xr[c] - mean, xr[c] - mean, q);
      for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      rstd = rsqrtf(q / C + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();
  const int tr = tid >> 4, tc = tid & 15;  // 8 rows x 4 columns per thread
  float acc[8][4] = {};
  for (int k0 = 0; k0 < C; k0 += FK) {
    for (int i = tid; i < FM * FK; i += FTHREADS) {
      const int r = i / FK, kk = i % FK, row = m0 + r, col = n0 + r, c = k0 + kk;
      sa[r * FLD + kk] = (row < R && c < C)
          ? fmaf((x[(size_t)row * C + c] - mean_s[r]) * rstd_s[r], gamma[c], beta[c]) : 0.f;
      sb[r * FLD + kk] = (col < N && c < C) ? w[(size_t)col * C + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sa[(tr * 8 + i) * FLD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[(tc * 4 + j) * FLD + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + tr * 8 + i, col = n0 + tc * 4 + j;
      if (row < R && col < N)
        out[(size_t)row * N + col] = acc[i][j] + (has_bias ? wb[col] : 0.f);
    }
}

}  // namespace

// stats: fp32 [R, 2] scratch for the bf16 path (unused for fp32)
extern "C" int ttv_ln_matmul(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* wb, void* out, void* stats, int R,
                             int C, int N, float eps, int has_bias, int is_bf16,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ln_stats<<<(R + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x),
                                           static_cast<float2*>(stats), R, C, eps);
    dim3 grid((R + BM - 1) / BM, (N + BN - 1) / BN);
    ln_matmul_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const float2*>(stats),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(w), static_cast<const float*>(wb), static_cast<bf16*>(out),
        R, C, N, has_bias);
  } else {
    dim3 grid((R + FM - 1) / FM, (N + FN - 1) / FN);
    ln_matmul_f32<<<grid, FTHREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const float*>(w),
        static_cast<const float*>(wb), static_cast<float*>(out), R, C, N, eps, has_bias);
  }
  return (int)cudaGetLastError();
}
