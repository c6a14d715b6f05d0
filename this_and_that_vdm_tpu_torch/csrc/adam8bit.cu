// K4: the 8-bit AdamW moment update of every leaf of a tree, in one launch,
// for Hopper.
//
// Replaces this_and_that_vdm_tpu/ops/adam8bit_pallas.py::_adam8bit_kernel
// (launched by _leaf_call, once a leaf).  Per 256-element quantisation block:
// dequantise the uint8 first moment (signed log codebook, 127 magnitudes)
// and second moment (unsigned, 255 magnitudes) times the block's fp32 absmax
// scale, update both as exponential moving averages, write the step
// m_hat / (sqrt(v_hat) + eps) with the bias corrections bc = (1 - b1^t,
// 1 - b2^t), and requantise each moment with its new block absmax.
//
// The TPU kernel takes a [512, 256] tile of one leaf per grid step, one
// launch a leaf.  A train step updates 655 (GestureNet) or 1428 (VL UNet)
// leaves, most of them a few blocks long, so here one launch takes them all:
// the wrapper sends a table of leaves (input pointers, numel, first global
// block; ops/adam8bit.py leaf_blocks), the blocks of all leaves are numbered
// in one sequence, and the new moments go to four arenas in that numbering
// (the step to each leaf's own output, which may be its gradient).  A
// persistent grid of 8-warp thread blocks takes the sequence in contiguous
// runs, one warp a quantisation block; a warp finds the leaf of its first
// block by a binary search over the table's first blocks, then walks
// forward.  Each lane holds 8 consecutive elements (two 16-byte loads of the
// gradient, one 8-byte load per moment); the block absmax is a 5-step warp
// shuffle, and lane 0 writes the scales.  The gradient is read
// only up to the leaf's numel (zeros past it, so no padded copy), and the
// moment codes of the ragged tail are the zero codes (127 signed, 0
// unsigned), which dequantise to 0 and requantise to the same codes.
//
// Decoding goes through two 256-entry tables in shared memory (16 copies
// each, interleaved so that the lanes of a warp spread over the banks),
// filled at block start by the same device expression (magnitude()), so a
// decoded moment is bit for bit what the expression gives, without two
// exp2f per element.  Division by the launch's constants (bias corrections,
// codebook constants) and by a block's scales goes through their correctly
// rounded reciprocals and two fma residual steps (div_rcp), which give the
// correctly rounded quotient without the special-function unit; the
// step's division stays __fdiv_rn.  The special-function unit did most of
// the work per element: from 14 operations an element to 4.
//
// Bound: bytes.  12 bytes a parameter (gradient and step fp32, two codes
// read and two written) plus 16 bytes of scales a block: 2.45 ms for the
// GestureNet's 0.681 B parameters at 3.35 TB/s, 47 us for its 13.1 M-parameter
// GEGLU leaf alone.
//
// Numerics follow the plain version (ops/adam8bit.py::_plain, the JAX jnp
// path) operation by operation: every product, sum and quotient is a
// separately rounded fp32 operation (__fmul_rn / __fadd_rn / __fdiv_rn, so
// nvcc contracts nothing into an FMA), log2f / exp2f are the full-precision
// library functions (no fast-math intrinsics), and the codebook constants
// arrive from the wrapper already folded in float64 and rounded to fp32.
#include <limits.h>
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

// x / d correctly rounded, without a division, for a divisor d whose
// correctly rounded reciprocal rd = RN(1/d) is known: RN(x rd) is within
// about an ulp of x / d, and each residual step (r = x - q d exactly, by
// fma; q + r rd) brings q closer; after the second, q is RN(x / d)
// (Markstein's theorem: q faithful and rd = RN(1/d) give a correctly
// rounded q + r rd).  The same bits as __fdiv_rn for the normal, finite
// operands met here, in five fma-pipe operations and no special function.
__device__ __forceinline__ float div_rcp(float x, float d, float rd) {
  float q = __fmul_rn(x, rd);
  float r = __fmaf_rn(-q, d, x);
  q = __fmaf_rn(r, rd, q);
  r = __fmaf_rn(-q, d, x);
  return __fmaf_rn(r, rd, q);
}

// the correctly rounded reciprocals of the launch's constant divisors
struct Recips {
  float bc0, bc1, midlo_m, steplog_m, midlo_v, steplog_v;
};

// nearest-magnitude index of a in [0, 1]: floor(log2(a / (mid*lo)) /
// (step*log2(10))) + 1, clamped to [0, n_mags - 1]
__device__ __forceinline__ float log_index(float a, float midlo, float rmidlo, float steplog,
                                           float rsteplog, float jmax, const Adam8Params& p) {
  const float x = div_rcp(fmaxf(a, p.floor_a), midlo, rmidlo);
  const float j = __fadd_rn(floorf(div_rcp(log2f(x), steplog, rsteplog)), 1.f);
  return fminf(fmaxf(j, 0.f), jmax);
}

__device__ __forceinline__ uint8_t encode_m(float v, const Adam8Params& p, const Recips& r) {
  const float a = fabsf(v);
  const float j = log_index(a, p.midlo_m, r.midlo_m, p.steplog_m, r.steplog_m, 126.f, p);
  const float q = a < p.zero_a ? 127.f : (v >= 0.f ? 128.f + j : 126.f - j);
  return static_cast<uint8_t>(static_cast<int>(q));
}

__device__ __forceinline__ uint8_t encode_v(float v, const Adam8Params& p, const Recips& r) {
  const float j = log_index(v, p.midlo_v, r.midlo_v, p.steplog_v, r.steplog_v, 254.f, p);
  return static_cast<uint8_t>(static_cast<int>(v < p.zero_a ? 0.f : 1.f + j));
}

// one row of the wrapper's int64 table (ops/adam8bit.py leaf_table)
struct Leaf {
  const float* g;     // [numel] gradient
  const uint8_t* mq;  // [nb * 256] first-moment codes
  const float* ms;    // [nb] first-moment scales
  const uint8_t* nq;  // [nb * 256] second-moment codes
  const float* ns;    // [nb] second-moment scales
  long long numel;
  long long first_block;  // of this leaf in the global numbering
  float* step;  // [numel] output; may be g itself (a lane reads its 8 before writing them)
};
static_assert(sizeof(Leaf) == 64, "the wrapper writes 8 int64 a leaf");

constexpr int COPIES = 16;  // decode tables, spread over the banks

__global__ void __launch_bounds__(THREADS)
    adam8bit_multi(const Leaf* __restrict__ leaves, int n_leaves, int total_blocks,
                   uint8_t* __restrict__ mq2, float* __restrict__ ms2,
                   uint8_t* __restrict__ nq2, float* __restrict__ ns2, const Adam8Params p) {
  // code -> decoded moment, 16 copies interleaved (entry c of copy k at
  // c * 16 + k): lane l reads copy l % 16, so two lanes meet on a bank only
  // when their codes' copies coincide, not on every equal code bank
  __shared__ float lut_m[256 * COPIES], lut_v[256 * COPIES];
  {
    const float dm = decode_m((float)threadIdx.x, p), dv = decode_v((float)threadIdx.x, p);
    for (int k = 0; k < COPIES; ++k) {
      const int kk = (k + threadIdx.x) % COPIES;  // spread the stores over the banks
      lut_m[threadIdx.x * COPIES + kk] = dm;
      lut_v[threadIdx.x * COPIES + kk] = dv;
    }
  }
  const Recips rc{__frcp_rn(p.bc0), __frcp_rn(p.bc1), __frcp_rn(p.midlo_m),
                  __frcp_rn(p.steplog_m), __frcp_rn(p.midlo_v), __frcp_rn(p.steplog_v)};
  __syncthreads();
  const int lane = threadIdx.x & 31, copy = lane % COPIES;
  // this thread block's contiguous run of global blocks, a warp every 8th
  const int per = (total_blocks + gridDim.x - 1) / gridDim.x;
  const int end = min(total_blocks, (blockIdx.x + 1) * per);
  int blk = blockIdx.x * per + threadIdx.x / 32;
  if (blk >= end) return;  // whole warps only: the shuffles below stay full
  // the leaf of the first block: the last one whose first block is <= blk
  // (empty leaves share their first block with the next and are passed over)
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first_block <= blk) lo = mid;
    else hi = mid - 1;
  }
  Leaf lf = leaves[lo];
  long long next = lo + 1 < n_leaves ? leaves[lo + 1].first_block : LLONG_MAX;
  for (; blk < end; blk += THREADS / 32) {
    while (blk >= next) {  // walk forward to the leaf of blk
      lf = leaves[++lo];
      next = lo + 1 < n_leaves ? leaves[lo + 1].first_block : LLONG_MAX;
    }
    const long long lb = blk - lf.first_block;
    const long long off = lb * QBLOCK + lane * 8;
    const long long numel = lf.numel;

    float gv[8];
    if (off + 8 <= numel) {
      ttv::load8(lf.g + off, gv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) gv[j] = off + j < numel ? lf.g[off + j] : 0.f;
    }
    const uint2 mc = *reinterpret_cast<const uint2*>(lf.mq + off);
    const uint2 nc = *reinterpret_cast<const uint2*>(lf.nq + off);
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mc);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(&nc);
    const float msc = lf.ms[lb], nsc = lf.ns[lb];

    float m[8], n[8], st[8];
    float am = 0.f, an = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float gj = gv[j];
      m[j] = __fadd_rn(__fmul_rn(p.b1, __fmul_rn(lut_m[mb[j] * COPIES + copy], msc)),
                       __fmul_rn(p.omb1, gj));
      n[j] = __fadd_rn(__fmul_rn(p.b2, __fmul_rn(lut_v[vb[j] * COPIES + copy], nsc)),
                       __fmul_rn(__fmul_rn(p.omb2, gj), gj));
      const float mhat = div_rcp(m[j], p.bc0, rc.bc0);
      const float nhat = div_rcp(n[j], p.bc1, rc.bc1);
      st[j] = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(nhat), p.eps));
      am = nanmax(am, fabsf(m[j]));
      an = nanmax(an, fabsf(n[j]));
    }
    if (off + 8 <= numel) {
      ttv::store8(lf.step + off, st);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (off + j < numel) lf.step[off + j] = st[j];
    }

#pragma unroll
    for (int s = 16; s; s >>= 1) {
      am = nanmax(am, __shfl_xor_sync(0xffffffffu, am, s));
      an = nanmax(an, __shfl_xor_sync(0xffffffffu, an, s));
    }
    const float sm = am > 0.f ? am : 1.f, sn = an > 0.f ? an : 1.f;
    const float rsm = __frcp_rn(sm), rsn = __frcp_rn(sn);
    uint2 mo, no;
    uint8_t* mob = reinterpret_cast<uint8_t*>(&mo);
    uint8_t* nob = reinterpret_cast<uint8_t*>(&no);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mob[j] = encode_m(div_rcp(m[j], sm, rsm), p, rc);
      nob[j] = encode_v(div_rcp(n[j], sn, rsn), p, rc);
    }
    const size_t o = (size_t)blk * QBLOCK + lane * 8;
    *reinterpret_cast<uint2*>(mq2 + o) = mo;
    *reinterpret_cast<uint2*>(nq2 + o) = no;
    if (lane == 0) {
      ms2[blk] = am;
      ns2[blk] = an;
    }
  }
}

}  // namespace

// leaves: device table [n_leaves] of Leaf (int64 x 8), first blocks
// ascending, summing to total_blocks; mq2 and nq2 [total_blocks * 256] uint8,
// ms2 and ns2 [total_blocks] fp32, in the global block numbering (the step
// goes to each leaf's own output); hp: 17 host floats (Adam8Params);
// max_grid: the most thread blocks worth launching (one per 8 quantisation
// blocks).  The grid is one wave: max_grid capped at what the card holds at
// once, so no thread block waits for a second wave.  The moment outputs
// must not alias inputs.
extern "C" int ttv_adam8bit_multi(const void* leaves, int n_leaves, int total_blocks,
                                  void* mq2, void* ms2, void* nq2, void* ns2, const float* hp,
                                  int max_grid, void* stream) {
  if (n_leaves <= 0 || total_blocks <= 0 || max_grid <= 0) return (int)cudaErrorInvalidValue;
  static ttv::PerDevice waves;  // thread blocks resident at once, per device
  int dev = 0;
  cudaError_t e = ttv::current_device(&dev);
  if (e != cudaSuccess) return (int)e;
  int wave = waves.v[dev].load(std::memory_order_relaxed);
  if (!wave) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam8bit_multi, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    wave = sms * per_sm;
    waves.v[dev].store(wave, std::memory_order_relaxed);
  }
  Adam8Params p;
  memcpy(&p, hp, sizeof(p));
  adam8bit_multi<<<min(max_grid, wave), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, total_blocks, static_cast<uint8_t*>(mq2),
      static_cast<float*>(ms2), static_cast<uint8_t*>(nq2), static_cast<float*>(ns2), p);
  return (int)cudaGetLastError();
}
