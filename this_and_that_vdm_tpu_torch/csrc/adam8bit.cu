// K4: one 8-bit AdamW moment update per leaf, for Hopper.
//
// Replaces this_and_that_vdm_tpu/ops/adam8bit_pallas.py::_adam8bit_kernel
// (launched by _leaf_call).  Per 256-element quantisation block: dequantise
// the uint8 first moment (signed log codebook, 127 magnitudes) and second
// moment (unsigned, 255 magnitudes) times the block's fp32 absmax scale,
// update both as exponential moving averages, write the step
// m_hat / (sqrt(v_hat) + eps) with the bias corrections bc = (1 - b1^t,
// 1 - b2^t), and requantise each moment with its new block absmax.
//
// The TPU kernel takes a [512, 256] tile per grid step and reduces each row
// on the VPU.  Here one warp owns one block: each lane holds 8 consecutive
// elements (two 16-byte loads of the gradient, one 8-byte load per moment),
// the block absmax is a 5-step warp shuffle, and lane 0 writes the scales.
// A thread block of 8 warps covers 8 blocks; the last block of a leaf is
// padded by the caller with zero gradient and the zero codes (127 signed,
// 0 unsigned), which dequantise to 0 and requantise to the same codes.
//
// Bound: bytes.  12 bytes a parameter (gradient and step fp32, two codes
// read and two written) plus 16 bytes of scales a block: 157 MB at the
// 13.1 M-parameter GEGLU leaf of the 1280-wide blocks, ~47 us at 3.35 TB/s.
//
// Numerics follow the plain version (ops/adam8bit.py::_plain, the JAX jnp
// path) operation by operation: every product, sum and quotient is a
// separately rounded fp32 operation (__fmul_rn / __fadd_rn / __fdiv_rn, so
// nvcc contracts nothing into an FMA), log2f / exp2f are the full-precision
// library functions (no fast-math intrinsics), and the codebook constants
// arrive from the wrapper already folded in float64 and rounded to fp32.
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, one quantisation block each
constexpr int QBLOCK = 256;

// fp32 constants, in the order of ops/adam8bit.py::_hyper
struct Adam8Params {
  float b1, b2, omb1, omb2, eps, bc0, bc1;
  float floor_a, zero_a, decades, log2_10;
  float step_m, midlo_m, steplog_m;  // signed codebook, 127 magnitudes
  float step_v, midlo_v, steplog_v;  // unsigned codebook, 255 magnitudes
};

// max that keeps a NaN, like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float magnitude(float j, float step, const Adam8Params& p) {
  return exp2f(__fmul_rn(__fsub_rn(__fmul_rn(j, step), p.decades), p.log2_10));
}

__device__ __forceinline__ float decode_m(float q, const Adam8Params& p) {
  const float j = q >= 128.f ? q - 128.f : 126.f - q;
  const float sign = q == 127.f ? 0.f : (q >= 128.f ? 1.f : -1.f);
  return __fmul_rn(sign, magnitude(j, p.step_m, p));
}

__device__ __forceinline__ float decode_v(float q, const Adam8Params& p) {
  const float sign = q == 0.f ? 0.f : 1.f;
  return __fmul_rn(sign, magnitude(q - 1.f, p.step_v, p));
}

// nearest-magnitude index of a in [0, 1]: floor(log2(a / (mid*lo)) /
// (step*log2(10))) + 1, clamped to [0, n_mags - 1]
__device__ __forceinline__ float log_index(float a, float midlo, float steplog,
                                           float jmax, const Adam8Params& p) {
  const float x = __fdiv_rn(fmaxf(a, p.floor_a), midlo);
  const float j = __fadd_rn(floorf(__fdiv_rn(log2f(x), steplog)), 1.f);
  return fminf(fmaxf(j, 0.f), jmax);
}

__device__ __forceinline__ uint8_t encode_m(float v, const Adam8Params& p) {
  const float a = fabsf(v);
  const float j = log_index(a, p.midlo_m, p.steplog_m, 126.f, p);
  const float q = a < p.zero_a ? 127.f : (v >= 0.f ? 128.f + j : 126.f - j);
  return static_cast<uint8_t>(static_cast<int>(q));
}

__device__ __forceinline__ uint8_t encode_v(float v, const Adam8Params& p) {
  const float j = log_index(v, p.midlo_v, p.steplog_v, 254.f, p);
  return static_cast<uint8_t>(static_cast<int>(v < p.zero_a ? 0.f : 1.f + j));
}

__global__ void __launch_bounds__(THREADS)
    adam8bit_kernel(const float* __restrict__ g, const uint8_t* __restrict__ mq,
                    const float* __restrict__ ms, const uint8_t* __restrict__ nq,
                    const float* __restrict__ ns, float* __restrict__ step,
                    uint8_t* __restrict__ mq2, float* __restrict__ ms2,
                    uint8_t* __restrict__ nq2, float* __restrict__ ns2, int nb,
                    const Adam8Params p) {
  const int blk = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (blk >= nb) return;  // whole warps only: the shuffles below stay full
  const size_t off = (size_t)blk * QBLOCK + lane * 8;

  float gv[8];
  ttv::load8(g + off, gv);
  const uint2 mc = *reinterpret_cast<const uint2*>(mq + off);
  const uint2 nc = *reinterpret_cast<const uint2*>(nq + off);
  const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mc);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(&nc);
  const float msc = ms[blk], nsc = ns[blk];

  float m[8], n[8], st[8];
  float am = 0.f, an = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float gj = gv[j];
    m[j] = __fadd_rn(__fmul_rn(p.b1, __fmul_rn(decode_m((float)mb[j], p), msc)),
                     __fmul_rn(p.omb1, gj));
    n[j] = __fadd_rn(__fmul_rn(p.b2, __fmul_rn(decode_v((float)vb[j], p), nsc)),
                     __fmul_rn(__fmul_rn(p.omb2, gj), gj));
    const float mhat = __fdiv_rn(m[j], p.bc0);
    const float nhat = __fdiv_rn(n[j], p.bc1);
    st[j] = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(nhat), p.eps));
    am = nanmax(am, fabsf(m[j]));
    an = nanmax(an, fabsf(n[j]));
  }
  ttv::store8(step + off, st);

#pragma unroll
  for (int s = 16; s; s >>= 1) {
    am = nanmax(am, __shfl_xor_sync(0xffffffffu, am, s));
    an = nanmax(an, __shfl_xor_sync(0xffffffffu, an, s));
  }
  const float sm = am > 0.f ? am : 1.f, sn = an > 0.f ? an : 1.f;
  uint2 mo, no;
  uint8_t* mob = reinterpret_cast<uint8_t*>(&mo);
  uint8_t* nob = reinterpret_cast<uint8_t*>(&no);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mob[j] = encode_m(__fdiv_rn(m[j], sm), p);
    nob[j] = encode_v(__fdiv_rn(n[j], sn), p);
  }
  *reinterpret_cast<uint2*>(mq2 + off) = mo;
  *reinterpret_cast<uint2*>(nq2 + off) = no;
  if (lane == 0) {
    ms2[blk] = am;
    ns2[blk] = an;
  }
}

}  // namespace

// g [nb, 256] fp32; mq, nq [nb, 256] uint8; ms, ns [nb] fp32; outputs of the
// same shapes; hp: 17 host floats (Adam8Params).  Outputs must not alias inputs.
extern "C" int ttv_adam8bit(const void* g, const void* mq, const void* ms, const void* nq,
                            const void* ns, void* step, void* mq2, void* ms2, void* nq2,
                            void* ns2, int nb, const float* hp, void* stream) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  Adam8Params p;
  memcpy(&p, hp, sizeof(p));
  const int blocks = (nb + THREADS / 32 - 1) / (THREADS / 32);
  adam8bit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(mq),
      static_cast<const float*>(ms), static_cast<const uint8_t*>(nq),
      static_cast<const float*>(ns), static_cast<float*>(step),
      static_cast<uint8_t*>(mq2), static_cast<float*>(ms2), static_cast<uint8_t*>(nq2),
      static_cast<float*>(ns2), nb, p);
  return (int)cudaGetLastError();
}
