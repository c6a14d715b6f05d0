// K2: GroupNorm (+ optional SiLU) over a folded [N, S, C] tensor, for Hopper.
//
// Replaces this_and_that_vdm_tpu/ops/groupnorm_pallas.py::_kernel (launched by
// _gn_pallas).  The TPU kernel holds one whole [S, C] batch row in VMEM
// (S*C*4 <= 8 MiB) and reads it once.  On the card a batch row of the
// full-resolution VAE decoder (256*384 positions x 128 channels x 8 frames)
// is far larger than a block's shared memory, and one block per row would
// leave most of the 132 SMs idle, so the reduction is split across blocks:
//
//   pass 1 (stats):  grid (split, N).  A block owns a run of positions.  Each
//                    thread owns one or two 8-channel pieces (16-byte loads
//                    for bf16) and walks positions with the threads that own
//                    the other pieces of the row, keeping fp32 sums and sums of
//                    squares in registers; the block folds them into per-group
//                    sums in shared memory and adds those into the fp32
//                    [N, G, 2] workspace with global atomics (the wrapper
//                    zeroes it).  Atomics make the order of the final
//                    additions vary from run to run (fp32 rounding only).
//   pass 2 (apply):  grid (blocks, N).  A block turns the workspace into a
//                    per-channel scale and shift in shared memory (variance
//                    clamped >= 0, rsqrt(var + eps), affine), then streams the
//                    tensor once in 8-element pieces: y = x * w[c] + b[c],
//                    optional SiLU, written in the input dtype.
//
// Bound: bytes.  One read in pass 1 and one read plus one write in pass 2,
// against the TPU kernel's one read and one write: 1.5x its traffic, the
// price of not holding the row on chip.  At [28, 1536, 320] bf16 that is
// 82.6 MB, ~25 us at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 4096;  // two 8-channel pieces per thread

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_stats(const T* __restrict__ x, float* __restrict__ ws, int S, int C, int G,
             int rows_per_block) {
  extern __shared__ float sg[];  // [G][2]
  const int n = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < 2 * G; i += THREADS) sg[i] = 0.f;
  __syncthreads();

  const int pieces = C / 8;                       // 8-channel pieces per position
  const int lanes = min(pieces, THREADS);         // threads spanning one position
  const int rows = THREADS / lanes;               // positions in flight
  const int rsub = tid / lanes, p0 = tid % lanes;  // pieces p0 and p0 + lanes
  const int s0 = blockIdx.x * rows_per_block;
  const int s1 = min(S, s0 + rows_per_block);
  float a1[2][8] = {}, a2[2][8] = {};
  const T* xn = x + (size_t)n * S * C;
  if (rsub < rows) {
    for (int s = s0 + rsub; s < s1; s += rows) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int p = p0 + k * lanes;
        if (p < pieces) {
          float v[8];
          ttv::load8(xn + (size_t)s * C + p * 8, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            a1[k][j] += v[j];
            a2[k][j] = fmaf(v[j], v[j], a2[k][j]);
          }
        }
      }
    }
    const int per = C / G;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = p0 + k * lanes;
      if (p < pieces) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int g = (p * 8 + j) / per;
          atomicAdd(&sg[2 * g], a1[k][j]);
          atomicAdd(&sg[2 * g + 1], a2[k][j]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * G; i += THREADS) atomicAdd(&ws[(size_t)n * 2 * G + i], sg[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_apply(const T* __restrict__ x, const float* __restrict__ ws,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             T* __restrict__ y, int S, int C, int G, float eps, int silu) {
  extern __shared__ float sw[];  // w[C], b[C]
  float* sb = sw + C;
  const int n = blockIdx.y, tid = threadIdx.x;
  const int per = C / G;
  const float count = (float)S * (float)per;
  for (int c = tid; c < C; c += THREADS) {
    const int g = c / per;
    const float mean = ws[(size_t)n * 2 * G + 2 * g] / count;
    // one-pass variance cancels slightly negative on (near-)constant groups
    const float var = fmaxf(ws[(size_t)n * 2 * G + 2 * g + 1] / count - mean * mean, 0.f);
    const float w = rsqrtf(var + eps) * gamma[c];
    sw[c] = w;
    sb[c] = beta[c] - mean * w;
  }
  __syncthreads();
  const unsigned total = (unsigned)S * (unsigned)C;  // < 2^31, checked by the wrapper
  const T* xn = x + (size_t)n * total;
  T* yn = y + (size_t)n * total;
  for (unsigned i = (blockIdx.x * THREADS + tid) * 8u; i < total; i += gridDim.x * THREADS * 8u) {
    const int c0 = (int)(i % (unsigned)C);
    float v[8];
    ttv::load8(xn + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = fmaf(v[j], sw[c0 + j], sb[c0 + j]);
      if (silu) v[j] = v[j] / (1.f + expf(-v[j]));
    }
    ttv::store8(yn + i, v);
  }
}

}  // namespace

extern "C" int ttv_groupnorm_stats(const void* x, void* ws, int N, int S, int C, int G,
                                   int rows_per_block, int is_bf16, void* stream) {
  if (C > MAX_C || C % G || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + rows_per_block - 1) / rows_per_block, N);
  size_t smem = sizeof(float) * 2 * G;
  if (is_bf16)
    gn_stats<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(ws), S, C, G,
        rows_per_block);
  else
    gn_stats<float><<<grid, THREADS, smem, st>>>(static_cast<const float*>(x),
                                                 static_cast<float*>(ws), S, C, G,
                                                 rows_per_block);
  return (int)cudaGetLastError();
}

extern "C" int ttv_groupnorm_apply(const void* x, const void* ws, const void* gamma,
                                   const void* beta, void* y, int N, int S, int C, int G,
                                   float eps, int silu, int blocks_per_row, int is_bf16,
                                   void* stream) {
  if (C > MAX_C || C % G || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(blocks_per_row, N);
  size_t smem = sizeof(float) * 2 * C;
  if (is_bf16)
    gn_apply<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ws),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<__nv_bfloat16*>(y), S, C, G, eps, silu);
  else
    gn_apply<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ws),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<float*>(y), S, C, G, eps, silu);
  return (int)cudaGetLastError();
}
