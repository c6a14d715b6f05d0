// K1: self-attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces this_and_that_vdm_tpu/ops/flash_attention.py::_kernel (launched by
// _flash_call).  The TPU kernel holds one whole fp32 [BQ, S] score tile in
// VMEM; a block here has at most 227 KB of shared memory, so it streams K/V
// in tiles of 64 keys with a running max and sum instead (the S x S scores
// never exist anywhere).
//
// Layout: q, k, v, o are [B, S, H, D], read in place through strides (no
// fold to [B*H, S, D] and no transpose copy).  Grid: (ceil(S/64), B*H); one
// block of 4 warps per 64-query tile, each warp owning 16 query rows.
//
// bf16 (the main path): FlashAttention-2 structure on mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  A warp keeps its Q fragments, the 16 x 64
// score tile, the softmax state and the 16 x D output accumulator in
// registers; the score accumulators are re-packed to bf16 as the A operand
// of P@V without leaving registers.  K is staged row-major and V transposed
// in shared memory, so every operand fragment is one 32-bit shared load.
// fp32: a simpler kernel with plain FMAs through shared memory, so fp32 stays
// full fp32 (mma's tf32 would keep ~3 digits); it is the comparison path.
//
// Numerics: scores and the softmax statistics are fp32; P is rounded to V's
// dtype before P@V, which accumulates in fp32; the output is divided by the
// fp32 row sum at the end.  Keys past S are masked to -inf and queries past
// S are not written, so any S works.
//
// Bound at the slice's shapes (S=1536, D=64, B*H=140, bf16): 4*B*H*S^2*D =
// 84.6 GFLOP against 2*4*B*S*H*D = 110 MB, i.e. compute-bound.  No wgmma,
// TMA or K/V double buffering yet: loads and products of a tile do not
// overlap within a block, only across the blocks resident on an SM.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;

// ----------------------------------------------------------- bf16 path

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: {a0, a1, a2, a3} = rows {g, g+8, g, g+8}, cols {2t, 2t, 2t+8, 2t+8} (+0, +1)
//   B 16x8:  {b0, b1} = rows {2t, 2t+8} (+0, +1), col g
//   C 16x8:  {c0, c1} = row g, cols 2t, 2t+1;  {c2, c3} = row g+8
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, float scale) {
  constexpr int LK = D + 8;   // sK row stride: conflict-free 32-bit fragment loads
  constexpr int LV = BK + 8;  // sVt row stride
  __shared__ __align__(16) bf16 sK[BK * LK];
  __shared__ __align__(16) bf16 sVt[D * LV];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const size_t row = (size_t)H * D;  // stride between sequence positions
  const size_t base = ((size_t)b * S * H + h) * D;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < S ? ld32(q + base + r0 * row + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(q + base + r1 * row + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(q + base + r0 * row + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(q + base + r1 * row + c + 8) : 0u;
  }
  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D / 8; i += THREADS) {
      const int key = i / (D / 8), c = (i % (D / 8)) * 8, s = k0 + key;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (s < S) {
        kv = *reinterpret_cast<const uint4*>(k + base + s * row + c);
        vv = *reinterpret_cast<const uint4*>(v + base + s * row + c);
      }
      *reinterpret_cast<uint4*>(sK + key * LK + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LV + key] = ve[j];
    }
    __syncthreads();

    float sacc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
      const bf16* kr = sK + (j * 8 + g) * LK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma16816(sacc[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        sacc[j][e] = key < S ? sacc[j][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds a key < S
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[j][e] = exp2f(sacc[j][e] - m[e >> 1]);
        sum[e >> 1] += sacc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // P (the score accumulators, rounded to bf16) as the A operand of P@V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack2(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack2(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vr = sVt + (n * 8 + g) * LV + kk * 16 + 2 * t;
        mma16816(oacc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + base + r0 * row + c) =
          pack2(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + base + r1 * row + c) =
          pack2(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

// ----------------------------------------------------------- fp32 path

template <int D>
struct F32Layout {
  static constexpr int LDT = D + 4;   // Q/K/V row stride
  static constexpr int LDS = BK + 4;  // score / P row stride
  static constexpr size_t bytes =
      sizeof(float) * (3 * BQ * LDT + BQ * LDS + BQ * LDT + 2 * BQ);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H, float scale) {
  using L = F32Layout<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * L::LDT;
  float* sV = sK + BK * L::LDT;
  float* sP = sV + BK * L::LDT;  // scores, then probabilities
  float* sO = sP + BQ * L::LDS;
  float* sM = sO + BQ * L::LDT;
  float* sL = sM + BQ;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const size_t row = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[r * L::LDT + c] = s < S ? q[base + s * row + c] : 0.f;
    sO[r * L::LDT + c] = 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  // lanes 2r, 2r+1 of a warp share query row r: 32 keys and D/2 outputs each
  const int r = (tid >> 5) * 16 + (lane >> 1), half = lane & 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, c = i % D, s = k0 + rr;
      sK[rr * L::LDT + c] = s < S ? k[base + s * row + c] : 0.f;
      sV[rr * L::LDT + c] = s < S ? v[base + s * row + c] : 0.f;
    }
    __syncthreads();
    float* prow = sP + r * L::LDS + half * (BK / 2);
    float mx = -INFINITY;
    for (int j = 0; j < BK / 2; ++j) {
      const int key = half * (BK / 2) + j;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(sQ[r * L::LDT + d], sK[key * L::LDT + d], acc);
      const float x = k0 + key < S ? acc * scale : -INFINITY;
      prow[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = expf(m_old - m_new);
    float sum = 0.f;
    for (int j = 0; j < BK / 2; ++j) {
      prow[j] = expf(prow[j] - m_new);
      sum += prow[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    if (half == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + sum;
    }
    const float* pr = sP + r * L::LDS;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
      float acc = sO[r * L::LDT + d] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], sV[j * L::LDT + d], acc);
      sO[r * L::LDT + d] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, c = i % D, s = q0 + rr;
    if (s < S) o[base + s * row + c] = sO[rr * L::LDT + c] / sL[rr];
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, float scale, cudaStream_t st) {
  constexpr size_t bytes = F32Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_f32<D><<<grid, THREADS, bytes, st>>>(static_cast<const float*>(q),
                                             static_cast<const float*>(k),
                                             static_cast<const float*>(v),
                                             static_cast<float*>(o), S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, float scale, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_bf16<D><<<grid, THREADS, 0, st>>>(static_cast<const bf16*>(q),
                                          static_cast<const bf16*>(k),
                                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                          S, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ttv_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int D, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? launch_bf16<64>(q, k, v, o, B, S, H, scale, st)
                   : launch_f32<64>(q, k, v, o, B, S, H, scale, st);
  if (D == 128)
    return is_bf16 ? launch_bf16<128>(q, k, v, o, B, S, H, scale, st)
                   : launch_f32<128>(q, k, v, o, B, S, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
