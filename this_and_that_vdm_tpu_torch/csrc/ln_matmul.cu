// K3: LayerNorm -> matmul (+ bias), for Hopper (sm_90a).
//
// Replaces this_and_that_vdm_tpu/ops/ln_matmul.py::_kernel (launched by
// _ln_matmul_pallas_local).  The TPU grid walks the column blocks of one row
// block in order, normalising the [BR, C] rows once into a VMEM scratch
// (xn_ref, under pl.when(j == 0)) and reusing them for every column block.
// Here a block does the same: it owns a row block and walks column tiles.
//
// bf16 (the main path): wgmma + TMA, 384 threads a block -- warpgroups 0 and
// 1 compute, one lane of warpgroup 2 is the producer (setmaxnreg gives the
// compute warpgroups 240 registers, the producer 24) -- and a persistent
// grid: the (row block, column tile) pairs, row-major, are cut into one
// contiguous range per block, at most one block per SM.  At each new row
// block
//   1. the producer's TMA brings x [BM, C] into shared memory, 128-byte
//      swizzled, in 64-column blocks (the counterpart of xn_ref);
//   2. the 8 compute warps, a few lanes to a row, take fp32 statistics
//      (mean, then the variance of the centred row: two passes, as
//      jnp.mean / jnp.var) from registers, and write the normalised, affine
//      row back in place rounded to bf16 -- before any product, as the TPU
//      kernel rounds xn to the input dtype;
// then the weight [N, C] (nn.Linear's K-major layout) streams through a
// ring of [BN, KW] TMA stages ("full" / "empty" mbarriers; a stage is
// released once its products are done, with the next chunk's products in
// flight behind them; at a new row block the first
// chunks are loaded before the rows, and the next rows are prefetched into
// L2).  The two compute warpgroups take alternate tiles, in turns (named
// barriers), so that one's epilogue overlaps the other's products; each
// runs wgmma m64n128k16 with both operands in shared memory into two fp32
// accumulators.  The epilogue (template parameter EPI) adds the fp32 bias,
// rounds once to bf16 and stores 16 bytes a lane after a quad shuffle.  The
// normalised tensor never reaches device memory.
//
// EPI_GEGLU, the feed-forward's GEGLU (ops/ln_matmul.ln_matmul_geglu): the
// weight is nn.Linear's [2N, C], the N rows of h and then the N of the gate,
// and out is [R, N] = h * gelu(gate).  Each 128-row part of a weight stage
// holds 64 rows of h and the same 64 rows of the gate, two TMA boxes of the
// one tensor map (rows n0 and N + n0), so a lane's accumulator columns
// 8j + 2t (+1) are h for j < 8 and their gate at j + 8, in the same thread:
// the epilogue adds both biases, takes the exact (erf) GELU of a part's 32
// gates a lane in one pass, multiplies in fp32, rounds once, and stores
// [BM, BN / 2].  The rows, the ring and the warpgroups' turns are the plain
// epilogue's, and the plain instances compile as before; the gate and the
// [R, 2N] projection never reach device memory.  The erf (about 25
// instructions, a chain of dependent FMAs) is what the epilogue adds: at
// C = 320 it outlasts the other warpgroup's products, at C = 1280 it hides.
//
// Tiles (chosen in Python by ops/ln_matmul.plan, a function of R, C, N):
//   WM = 2: BM = 128 rows, BN = 128 -- while the normalised [128, C] fits
//           with >= 2 stages (C <= 640 here);
//   WM = 1: BM = 64 rows, BN = 256 -- C <= 1280; weight stages of 32
//           columns at 64-byte swizzle, 4 of them.
// Rows past R, columns past N and C past a multiple of 64 are zero-filled
// by TMA and never stored.  C % 8 == 0, N % 8 == 0 and 16-byte-aligned x, w
// and out (the wrapper checks).
//
// fp32 (the training path: the trainable GestureNet and the VL UNet are
// fp32): the product runs on the tensor cores in 3xTF32 (hopper.cuh), so it
// keeps fp32 accuracy (one TF32 product keeps ~3 digits, three ~2^-21).  It
// is built on mma.sync m16n8k8 with the hi / lo split done in registers as
// each fragment is loaded: normalised rows hi + lo would need twice the
// shared memory (320 KB for 128 rows at C = 320), and the mma.sync
// fragments are loaded 8 bytes a lane from plain row-major tiles.  128 x 128
// output tiles, 16 warps of 32 x 32, and the same persistent walk as bf16: a
// block takes a contiguous range of (row block, column tile) pairs.  The
// rows are normalised once (fp32 statistics in two passes, as jnp.mean /
// jnp.var, then the affine), in one of two ways (ops/ln_matmul.plan_f32):
//   - resident (C <= 320, where 128 fp32 rows fit beside the ring): the
//     tiles go row-major; at each new row block cp.async brings x [128, C]
//     into shared memory and the warps normalise it in place, once per row
//     block (the TPU kernel's xn_ref); the weight streams through a ring of
//     [128, 32] chunks;
//   - streamed (C > 320): a first pass (ln_matmul_f32_rows, a warp a row)
//     writes the normalised rows once to a device scratch [R, C] (at most
//     14 MB at the port's sites: it stays in L2), and each ring stage holds
//     a [128, 32] chunk of the rows beside the weight's; the tiles go
//     column-major, so a column tile's weight chunks are reused from L2
//     across row blocks.  Rows that stayed in shared memory would allow only
//     32 rows a block at C = 1280, and the 52 MB GEGLU weight would then be
//     read from device memory once per 32 rows.
// The ring keeps the load of chunk i + STAGES - 1 in flight while chunk i
// computes, across tiles.  Each of the three products runs over all of a
// warp's tiles before the next, so consecutive mma.sync are independent; the
// epilogue adds the fp32 bias and stores 8 bytes a lane.  The product's k
// index is mapped to columns (2t, 2t + 1) of both operands, so every
// fragment is one 8-byte load; row strides of 8 mod 32 floats keep those
// loads free of bank conflicts.  Rows past R and weight rows past N are
// zero-filled and never stored; C past a multiple of 32 is zero.
//
// Bound at the slice's shapes: R=43008, C=320, N=960 (qkv) is 26 GFLOP
// against ~110 MB, bound by bytes at 989 TFLOP/s by a hair; C=1280, N=10240
// at R=2688 is 70 GFLOP, tensor-core bound.  At WM = 1 each weight byte
// feeds only 64 rows, so the weight stream from L2 is what limits it.  In
// fp32 every product is three TF32 products (a third of 495 TFLOP/s), so
// the qkv site is bound by operations.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ------------------------------------------------------------ bf16 path

constexpr int THREADS_BF16 = 384;  // warpgroups 0-1 compute, warpgroup 2 produces (one lane)
constexpr int UNITS = 5;           // 16-byte pieces of a row per lane: C <= 32 * 8 * UNITS
constexpr int kSmemLimit = 232448;  // shared memory one block may use on sm_90

// sum over the `lanes` (a power of two) consecutive lanes of a row group
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Normalise the BM rows of x in sA in place (compute warp cw of 8).  A row
// is held by the fewest lanes (a power of two, `lanes`) that keep it in
// UNITS pieces of 8 columns each, so a warp works on 32 / lanes rows at once
// (4 at C = 320).  Piece j of row r sits in 64-column block j / 8 at the
// 16-byte slot (j % 8) ^ (r % 8): the 128-byte swizzle of the TMA.
template <int BM>
__device__ __forceinline__ void normalise_rows(uint8_t* sA, int cw, int lane, int C,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta, float eps) {
  const int pieces = C >> 3;
  int lanes = 1;
  while (lanes * UNITS < pieces) lanes <<= 1;
  const int per_warp = 32 / lanes, sub = lane % lanes;
  for (int r = cw * per_warp + lane / lanes; r < BM; r += 8 * per_warp) {
    uint8_t* row = sA + r * 128;
    uint4 v[UNITS];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int j = sub + lanes * i;
      if (j < pieces) {
        v[i] = *reinterpret_cast<const uint4*>(row + (j >> 3) * BM * 128 + (((j & 7) ^ (r & 7)) << 4));
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) s += __bfloat162float(e[k]);
      }
    }
    const float mean = group_sum(s, lanes) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      if (sub + lanes * i < pieces) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = __bfloat162float(e[k]) - mean;
          q = fmaf(d, d, q);
        }
      }
    }
    const float rstd = rsqrtf(group_sum(q, lanes) / C + eps);
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int j = sub + lanes * i;
      if (j < pieces) {
        const int c = j * 8;
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma + c));
        const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma + c + 4));
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(beta + c));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(beta + c + 4));
        const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
        uint4 y;
        bf16* ye = reinterpret_cast<bf16*>(&y);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          ye[k] = __float2bfloat16(fmaf((__bfloat162float(e[k]) - mean) * rstd, gm[k], bt[k]));
        *reinterpret_cast<uint4*>(row + (j >> 3) * BM * 128 + (((j & 7) ^ (r & 7)) << 4)) = y;
      }
    }
  }
}

// Row block BM, column tile BN, and the weight stage: KW columns of C
// (64 at 128-byte swizzle; 32 at 64-byte swizzle, so that C = 1280 keeps 4
// stages in flight beside its 160 KB of normalised rows).  A warpgroup
// computes a whole BM x BN tile as two 64 x 128 parts: rows (WM = 2) or
// columns (WM = 1).
template <int WM>
struct LnTiles {
  static constexpr int BM = 64 * WM, BN = 128 * (2 / WM);
  static constexpr int KW = WM == 2 ? 64 : 32;
  static constexpr int STAGE = BN * KW * 2;  // bytes
  static constexpr int SBO = 8 * KW * 2;     // 8-row swizzle atom
  static constexpr uint64_t LAYOUT = WM == 2 ? 1 : 2;
};

// Shared memory: sA [KB][BM rows][128 bytes], then the ring [stages][BN
// rows][KW * 2 bytes], then 2 * stages + 2 barriers; 1024 bytes of slack
// align the tiles.  Must match ops/ln_matmul.plan.
template <int WM>
size_t ln_smem_bytes(int C, int stages) {
  using T = LnTiles<WM>;
  return 1024 + (size_t)((C + 63) / 64) * T::BM * 128 + (size_t)stages * T::STAGE +
         8 * (2 * stages + 2);
}

// The epilogues: + bias to [R, N]; or the GEGLU of the two halves of a
// [2N, C] weight (h, then the gate) to [R, N]
enum : int { EPI_BIAS = 0, EPI_GEGLU = 1 };

// the fp32 bias of accumulator block j (columns c + 8j, c + 8j + 1; zero
// past N or without one); EPI_GEGLU: blocks 0-7 are h's columns c + 8j and
// blocks 8-15 the gate's of the same columns, N further on in wb
template <int EPI>
__device__ __forceinline__ void load_bias(float2 (&bias)[16], const float* __restrict__ wb,
                                          int c, int N) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if constexpr (EPI == EPI_GEGLU)
      bias[j] = (wb != nullptr && c + 8 * (j & 7) < N)
                    ? __ldg(reinterpret_cast<const float2*>((j < 8 ? wb : wb + N) + c + 8 * (j & 7)))
                    : make_float2(0.f, 0.f);
    else
      bias[j] = (wb != nullptr && c + 8 * j < N)
                    ? __ldg(reinterpret_cast<const float2*>(wb + c + 8 * j))
                    : make_float2(0.f, 0.f);
  }
}

// exact GELU in fp32, as torch's: x / 2 * (1 + erf(x / sqrt(2)))
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

// EPI_GEGLU, before a part is stored: its gate blocks 8-15 become
// gelu(gate + bias) in place, all 32 of a lane's in one pass (independent:
// more of them in flight than when each pair waits for its store)
__device__ __forceinline__ void gelu_gates(float (&acc)[64], const float2 (&bias)[16]) {
#pragma unroll
  for (int j = 8; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = gelu_erf(acc[4 * j + e] + (e & 1 ? bias[j].y : bias[j].x));
}

// one output pair of accumulator block jb, row half hh, in fp32 -> bf16x2:
// + bias, and under EPI_GEGLU times its gate's GELU (block jb + 8, from
// gelu_gates)
template <int EPI>
__device__ __forceinline__ uint32_t epilogue_pair(const float (&acc)[64],
                                                  const float2 (&bias)[16], int jb, int hh) {
  const float y0 = acc[4 * jb + 2 * hh] + bias[jb].x, y1 = acc[4 * jb + 2 * hh + 1] + bias[jb].y;
  if constexpr (EPI == EPI_GEGLU)
    return hop::pack_bf16(y0 * acc[4 * (jb + 8) + 2 * hh], y1 * acc[4 * (jb + 8) + 2 * hh + 1]);
  else
    return hop::pack_bf16(y0, y1);
}

// the epilogue, one rounding, 16 bytes a lane: one 64 x 128 accumulator
// part, rows row0 (+8), output columns col0 + 8j + 2t (+1) of its 16 blocks
// j (EPI_GEGLU: of its 8 blocks of h)
template <int EPI>
__device__ __forceinline__ void store_part(const float (&acc)[64], const float2 (&bias)[16],
                                           bf16* __restrict__ out, int row0, int col0, int t,
                                           int R, int N) {
#pragma unroll
  for (int gr = 0; gr < (EPI == EPI_GEGLU ? 2 : 4); ++gr)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = epilogue_pair<EPI>(acc, bias, 4 * gr + i, hh);
      const uint4 u = hop::quad_transpose(w, t);
      const int row = row0 + 8 * hh, col = col0 + 8 * (4 * gr + t);
      if (row < R && col < N) *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = u;
    }
}

// tiles: (row block, column tile) in row-major order; a block takes one
// contiguous range of them and its warpgroups take turns, tile by tile.  N
// is out's width; a tile stores OBN of its columns, a part PART_N.
template <int WM, int EPI>
__global__ void __launch_bounds__(THREADS_BF16, 1)
    ln_matmul_bf16(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ wb, bf16* __restrict__ out, int R, int C, int N,
                   float eps, int stages, int tiles_n, int tiles) {
  using T = LnTiles<WM>;
  constexpr int BM = T::BM, BN = T::BN, KW = T::KW;
  constexpr int OBN = EPI == EPI_GEGLU ? BN / 2 : BN, PART_N = EPI == EPI_GEGLU ? 64 : 128;
  const int KB = (C + 63) / 64, KC = (C + KW - 1) / KW;  // 64-column blocks, weight chunks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sA = hop::align1024(smem_raw);
  uint8_t* ring = sA + KB * BM * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * T::STAGE);
  uint64_t* empty = full + stages;
  uint64_t* a_full = empty + stages;
  uint64_t* a_empty = a_full + 1;

  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4);  // the 4 warps of the warpgroup that owns the tile
    }
    hop::mbar_init(a_full, 1);
    hop::mbar_init(a_empty, 8);
    hop::fence_barrier_init();
  }
  __syncthreads();

  // 384 threads leave ptxas 168 registers a thread; the producer warpgroup
  // gives back all but 24 and the compute warpgroups take 240, for two
  // 64-register accumulators and the epilogue
  if (warp >= 8) {  // producer: one lane issues every copy, tile by tile
    hop::regs_dec<24>();
    if (warp == 8 && lane == 0) {
      int it = 0, seg = 0;
      auto load_w = [&](int kc, int nt) {
        const int s = it % stages, u = it / stages;
        if (u > 0) hop::mbar_wait(&empty[s], (u - 1) & 1);
        hop::mbar_expect_tx(&full[s], T::STAGE);
        if constexpr (EPI == EPI_GEGLU) {
          // each 128-row part: 64 rows of h, then the same 64 of the gate
          for (int q = 0; q < BN / 128; ++q)
            for (int hg = 0; hg < 2; ++hg)
              hop::tma_load_2d(ring + s * T::STAGE + (128 * q + 64 * hg) * KW * 2, &mw, &full[s],
                               kc * KW, hg * N + nt * OBN + 64 * q);
        } else {
          hop::tma_load_2d(ring + s * T::STAGE, &mw, &full[s], kc * KW, nt * BN);
        }
        ++it;
      };
      for (int tt = t0; tt < t1; ++tt) {
        const int rb = tt / tiles_n, nt = tt % tiles_n;
        int kc = 0;
        if (tt == t0 || nt == 0) {  // a new row block: x once, when sA is free
          if (seg > 0) {
            // the new tile's first weight chunks need only free stages
            for (; kc < KC && kc < stages; ++kc) load_w(kc, nt);
            hop::mbar_wait(a_empty, (seg - 1) & 1);
          }
          hop::mbar_expect_tx(a_full, KB * BM * 128);
          for (int kb = 0; kb < KB; ++kb)
            hop::tma_load_2d(sA + kb * BM * 128, &mx, a_full, kb * 64, rb * BM);
          if ((rb + 1) * tiles_n < t1)  // this range's next row block, into L2
            for (int kb = 0; kb < KB; ++kb) hop::tma_prefetch_2d(&mx, kb * 64, (rb + 1) * BM);
          ++seg;
        }
        for (; kc < KC; ++kc) load_w(kc, nt);
      }
    }
  } else {
  hop::regs_inc<240>();
  // compute warpgroup wg: the tiles t0 + wg, t0 + wg + 2, ...; part p of a
  // tile is rows p*64 .. (WM = 2) or columns p*128 .. (WM = 1)
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  float acc0[64], acc1[64];
  int seg = 0;
  // Turns (named barriers 2 and 3): a warpgroup starts its tile's products
  // only after the other has taken every chunk of the tile before, so no
  // warpgroup waits on a stage more than one ring lap ahead (a parity wait
  // cannot tell laps apart) -- and one's epilogue overlaps the other's loop.
  auto my_turn = [&]() { hop::named_sync(2 + wg, 256); };
  auto your_turn = [&](int tt) {
    if (tt + 1 < t1) hop::named_arrive(3 - wg, 256);  // the other has a next tile
  };
  if (wg == 1 && t0 < t1) hop::named_arrive(2, 256);  // warpgroup 0 starts
  for (int tt = t0; tt < t1; ++tt) {
    const int rb = tt / tiles_n, nt = tt % tiles_n;
    if (tt == t0 || nt == 0) {  // both warpgroups normalise each row block
      if (tt != t0 && lane == 0) hop::mbar_arrive(a_empty);  // done with the old rows
      hop::mbar_wait(a_full, seg & 1);
      normalise_rows<BM>(sA, warp, lane, C, gamma, beta, eps);
      hop::fence_async_smem();  // the normalised rows, visible to wgmma
      hop::named_sync(1, 256);
      ++seg;
    }
    if (((tt - t0) & 1) != wg) continue;

    my_turn();
    int held = -1;  // the stage of the chunk still in flight
    for (int kc = 0; kc < KC; ++kc) {
      const int it = (tt - t0) * KC + kc, s = it % stages;
      hop::mbar_wait(&full[s], (it / stages) & 1);
      // every stage the other warpgroup will wait on has now been waited on
      // once (here or by it), so it may start while this chunk computes
      if (kc == KC - 1) your_turn(tt);
      const uint8_t* bt = ring + s * T::STAGE;
      // columns kc*KW .. of C: 64-column block and byte offset inside its row
      const uint8_t* at = sA + (kc * KW / 64) * BM * 128 + (kc * KW % 64) * 2;
      constexpr int A1 = WM == 2 ? 64 * 128 : 0, B1 = WM == 2 ? 0 : 128 * KW * 2;  // part 1
      hop::fence_acc(acc0);
      hop::fence_acc(acc1);
      hop::wg_fence();
#pragma unroll
      for (int ks = 0; ks < KW / 16; ++ks) {
        hop::wgmma_ss(acc0, hop::desc(at + ks * 32, 16, 1024),
                      hop::desc(bt + ks * 32, 16, T::SBO, T::LAYOUT), kc > 0 || ks > 0);
        hop::wgmma_ss(acc1, hop::desc(at + A1 + ks * 32, 16, 1024),
                      hop::desc(bt + B1 + ks * 32, 16, T::SBO, T::LAYOUT), kc > 0 || ks > 0);
      }
      hop::wg_commit();
      // one chunk stays in flight, so the tensor pipe does not drain between
      // chunks; the one before it is done and its stage is free
      if (held >= 0) {
        hop::wg_wait<1>();
        if (lane == 0) hop::mbar_arrive(&empty[held]);
      }
      held = s;
    }
    hop::wg_wait<0>();
    hop::fence_acc(acc0);
    hop::fence_acc(acc1);
    if (lane == 0) hop::mbar_arrive(&empty[held]);

    // epilogue (overlaps the other warpgroup's products): the bias of this
    // lane's columns of a part is loaded at once, then the part is stored
    const int row0 = rb * BM + wl * 16 + g, col0 = nt * OBN;
    float2 bias[16];
    load_bias<EPI>(bias, wb, col0 + 2 * t, N);
    if constexpr (EPI == EPI_GEGLU) gelu_gates(acc0, bias);
    store_part<EPI>(acc0, bias, out, row0, col0, t, R, N);
    if (WM == 1) load_bias<EPI>(bias, wb, col0 + PART_N + 2 * t, N);
    if constexpr (EPI == EPI_GEGLU) gelu_gates(acc1, bias);
    store_part<EPI>(acc1, bias, out, row0 + (WM == 2 ? 64 : 0), col0 + (WM == 2 ? 0 : PART_N), t,
                    R, N);
  }
  }
}

// N: out's width; the weight has N rows, or 2N under EPI_GEGLU (loaded in
// boxes of 64 rows, two to a 128-row part)
template <int WM, int EPI>
int launch_bf16(const void* x, const void* gamma, const void* beta, const void* w,
                const void* wb, void* out, int R, int C, int N, float eps, int stages, int grid,
                int smem, cudaStream_t st) {
  using T = LnTiles<WM>;
  constexpr bool GEGLU = EPI == EPI_GEGLU;
  if (stages < 2 || (size_t)smem < ln_smem_bytes<WM>(C, stages) || smem > kSmemLimit ||
      C > 32 * 8 * UNITS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const cuuint64_t xdims[2] = {(cuuint64_t)C, (cuuint64_t)R};
  const cuuint64_t wdims[2] = {(cuuint64_t)C, (cuuint64_t)(GEGLU ? 2 * N : N)};
  const cuuint64_t stride[1] = {(cuuint64_t)C * 2};
  const cuuint32_t xbox[2] = {64, (cuuint32_t)T::BM};
  const cuuint32_t wbox[2] = {(cuuint32_t)T::KW, (cuuint32_t)(GEGLU ? 64 : T::BN)};
  int err = hop::make_map(&mx, x, 2, xdims, stride, xbox);
  if (!err) err = hop::make_map(&mw, w, 2, wdims, stride, wbox, T::KW == 32);
  if (err) return err;
  static ttv::PerDevice allowed;
  const cudaError_t e = ttv::allow_smem(reinterpret_cast<const void*>(ln_matmul_bf16<WM, EPI>),
                                        kSmemLimit, allowed);
  if (e != cudaSuccess) return (int)e;
  const int obn = GEGLU ? T::BN / 2 : T::BN;
  const int tiles_n = (N + obn - 1) / obn;
  const int tiles = (R + T::BM - 1) / T::BM * tiles_n;
  ln_matmul_bf16<WM, EPI><<<grid, THREADS_BF16, smem, st>>>(
      mx, mw, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(wb), static_cast<bf16*>(out), R, C, N, eps, stages, tiles_n,
      tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32 path

// row stride of the normalised rows (floats): C rounded up to 32, + 8, so
// that it is 8 mod 32.  Must match ops/ln_matmul.plan_f32.
__host__ __device__ __forceinline__ int f32_lda(int C) { return (C + 31) / 32 * 32 + 8; }

// Tiles of the fp32 kernel: 128 x 128 output tiles, chunks of KW = 32
// columns of C (row stride KW + 8 floats) in a ring of STAGES, 4 x 4 warps
// of 32 x 32 (MT = 2 m16 tiles x NT = 4 n8 tiles).  STREAM: the rows come
// normalised from a device scratch through the ring beside the weights (a
// stage holds both), instead of staying in shared memory.  Must match
// ops/ln_matmul.plan_f32.
template <bool STREAM_>
struct F32Cfg {
  static constexpr bool STREAM = STREAM_;
  static constexpr int BM = 128, BN = 128, WM = 4, WN = 4, KW = 32, STAGES = STREAM ? 4 : 3;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);
  static constexpr int LDW = KW + 8, STAGE = ((STREAM ? BM : 0) + BN) * LDW;  // floats
};

template <typename Cf>
size_t f32_smem(int C) {
  return 4 * ((Cf::STREAM ? 0 : (size_t)Cf::BM * f32_lda(C)) + (size_t)Cf::STAGES * Cf::STAGE);
}

// The LayerNorm of one row a warp (two passes, as jnp.mean / jnp.var), in
// place in shared memory (srow) or from x into xn in device memory.
__device__ __forceinline__ float2 row_stats(const float* row, int C, int lane, float eps) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += row[c];
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) q = fmaf(row[c] - mean, row[c] - mean, q);
  for (int o = 16; o; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  return make_float2(mean, rsqrtf(q / C + eps));
}

__global__ void __launch_bounds__(256)
    ln_matmul_f32_rows(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ xn, int R, int C,
                       float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* xr = x + (size_t)row * C;
  const float2 st = row_stats(xr, C, lane, eps);
  float* yr = xn + (size_t)row * C;
  for (int c = lane; c < C; c += 32) yr[c] = fmaf((xr[c] - st.x) * st.y, gamma[c], beta[c]);
}

// tiles: (row block, column tile) pairs, row-major (resident rows: a block
// normalises a row block when it reaches it) or column-major (STREAM: the
// weight chunks of a column tile are reused from L2 across row blocks); a
// block takes one contiguous range of them
template <typename Cf>
__global__ void __launch_bounds__(Cf::THREADS, 1)
    ln_matmul_f32(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ w,
                  const float* __restrict__ wb, float* __restrict__ out, int R, int C, int N,
                  float eps, int tiles_n, int tiles) {
  constexpr int BM = Cf::BM, BN = Cf::BN, KW = Cf::KW, LDW = Cf::LDW, MT = Cf::MT, NT = Cf::NT;
  constexpr int THREADS = Cf::THREADS, STAGES = Cf::STAGES, CPW = KW / 4;  // CPW: 16-byte pieces of a chunk row
  extern __shared__ float4 smem_f4[];
  float* sA = reinterpret_cast<float*>(smem_f4);  // resident rows: [BM][lda]
  const int lda = Cf::STREAM ? LDW : f32_lda(C);   // row stride of the rows the warps read
  float* ring = sA + (Cf::STREAM ? 0 : BM * lda);  // [STAGES][(BM if STREAM) + BN][LDW]
  const int KC = (C + KW - 1) / KW, tiles_m = tiles / tiles_n;
  const int t0 = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int total = (t1 - t0) * KC;  // (tile, chunk) pairs: the ring's sequence
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  auto row_block = [&](int tile) { return Cf::STREAM ? tile % tiles_m : tile / tiles_n; };
  auto col_tile = [&](int tile) { return Cf::STREAM ? tile / tiles_m : tile % tiles_n; };

  auto load_rows = [&](int rb) {  // x [BM, C], the padding to 32 columns zero
    const int cpr = lda / 4 - 2;
    for (int i = tid; i < BM * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 4, row = rb * BM + r;
      const bool ok = row < R && c < C;
      hop::cp_async16(sA + r * lda + c, x + (ok ? (size_t)row * C + c : 0), ok);
    }
    hop::cp_async_commit();
  };
  auto normalise_rows = [&]() {  // in place, a warp a row
    for (int r = warp; r < BM; r += THREADS / 32) {
      float* row = sA + r * lda;
      const float2 st = row_stats(row, C, lane, eps);
      for (int c = lane; c < C; c += 32) row[c] = fmaf((row[c] - st.x) * st.y, gamma[c], beta[c]);
    }
  };
  auto load_chunk = [&](int it) {  // the weight chunk (and, STREAM, the rows' chunk)
    const int tile = t0 + it / KC, kc = it % KC, n0 = col_tile(tile) * BN;
    float* st = ring + (it % STAGES) * Cf::STAGE;
    for (int i = tid; i < BN * CPW; i += THREADS) {
      const int r = i / CPW, c = (i % CPW) * 4, n = n0 + r, cc = kc * KW + c;
      const bool ok = n < N && cc < C;
      hop::cp_async16(st + r * LDW + c, w + (ok ? (size_t)n * C + cc : 0), ok);
    }
    if constexpr (Cf::STREAM) {
      const int m0 = row_block(tile) * BM;
      for (int i = tid; i < BM * CPW; i += THREADS) {
        const int r = i / CPW, c = (i % CPW) * 4, row = m0 + r, cc = kc * KW + c;
        const bool ok = row < R && cc < C;
        hop::cp_async16(st + (BN + r) * LDW + c, x + (ok ? (size_t)row * C + cc : 0), ok);
      }
    }
  };

  // 1. the first rows (resident), then the first chunks; 2. normalise
  int cur_rb = row_block(t0);
  if (!Cf::STREAM && t0 < t1) load_rows(cur_rb);
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < total) load_chunk(it);
    hop::cp_async_commit();
  }
  if constexpr (!Cf::STREAM) {
    hop::cp_async_wait<STAGES - 1>();
    __syncthreads();
    normalise_rows();
    // (the first sync of the loop below publishes the normalised rows)
  }

  // 3. the chunks, tile after tile; warp (wm, wn) owns rows wm * MT * 16 ..
  // and columns wn * NT * 8 .. of each BM x BN tile
  const int wm = warp / Cf::WN, wn = warp % Cf::WN;
  const int a_off = (wm * MT * 16 + g) * lda + 2 * t;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int tile = t0 + it / KC, kc = it % KC, rb = row_block(tile), nt = col_tile(tile);
    if (!Cf::STREAM && kc == 0 && rb != cur_rb) {  // a new row block: normalise it
      __syncthreads();                              // every warp is done with the old rows
      load_rows(rb);
      hop::cp_async_wait<0>();
      __syncthreads();
      normalise_rows();
      cur_rb = rb;
    }
    hop::cp_async_wait<STAGES - 2>();  // chunk it landed for this thread...
    __syncthreads();                   // ...and for all; the stage of it - 1 is free
    if (it + STAGES - 1 < total) load_chunk(it + STAGES - 1);
    hop::cp_async_commit();
    const float* st = ring + (it % STAGES) * Cf::STAGE;
    const float* ak = (Cf::STREAM ? st + BN * LDW : sA + kc * KW) + a_off;
    const float* bk = st + (wn * NT * 8 + g) * LDW + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KW / 8; ++ks) {  // k step: columns 8ks + (2t, 2t + 1)
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 x0 = *reinterpret_cast<const float2*>(ak + i * 16 * lda + 8 * ks);
        const float2 x1 = *reinterpret_cast<const float2*>(ak + (i * 16 + 8) * lda + 8 * ks);
        hop::split_tf32(x0.x, ah[i][0], al[i][0]);
        hop::split_tf32(x1.x, ah[i][1], al[i][1]);
        hop::split_tf32(x0.y, ah[i][2], al[i][2]);
        hop::split_tf32(x1.y, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const float2 y = *reinterpret_cast<const float2*>(bk + jn * 8 * LDW + 8 * ks);
        hop::split_tf32(y.x, bh[jn][0], bl[jn][0]);
        hop::split_tf32(y.y, bh[jn][1], bl[jn][1]);
      }
      // the three products, each over every (i, jn) before the next, so
      // that consecutive mma.sync are independent
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) hop::mma_tf32(acc[i][jn], al[i], bh[jn][0], bh[jn][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) hop::mma_tf32(acc[i][jn], ah[i], bl[jn][0], bl[jn][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) hop::mma_tf32(acc[i][jn], ah[i], bh[jn][0], bh[jn][1]);
    }
    if (kc == KC - 1) {  // 4. the tile is done: + bias, store, start the next
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int col = nt * BN + wn * NT * 8 + jn * 8 + 2 * t;
        float2 bias = make_float2(0.f, 0.f);
        if (wb != nullptr) {
          if (col < N) bias.x = wb[col];
          if (col + 1 < N) bias.y = wb[col + 1];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rb * BM + wm * MT * 16 + i * 16 + g + 8 * hh;
            const float y0 = acc[i][jn][2 * hh] + bias.x, y1 = acc[i][jn][2 * hh + 1] + bias.y;
            acc[i][jn][2 * hh] = acc[i][jn][2 * hh + 1] = 0.f;
            if (row >= R || col >= N) continue;
            float* p = out + (size_t)row * N + col;
            if ((N & 1) == 0) {
              *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
            } else {
              p[0] = y0;
              if (col + 1 < N) p[1] = y1;
            }
          }
      }
    }
  }
}

// STREAM: the rows are normalised once into scratch ([R, C] fp32) by
// ln_matmul_f32_rows, then streamed
template <typename Cf>
int launch_f32(const void* x, const void* gamma, const void* beta, const void* w,
               const void* wb, void* out, void* scratch, int R, int C, int N, float eps,
               int grid, int smem, cudaStream_t st) {
  if ((size_t)smem < f32_smem<Cf>(C) || smem > kSmemLimit || grid < 1 ||
      (Cf::STREAM && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  static ttv::PerDevice allowed;
  const cudaError_t e = ttv::allow_smem(reinterpret_cast<const void*>(ln_matmul_f32<Cf>),
                                        kSmemLimit, allowed);
  if (e != cudaSuccess) return (int)e;
  const float* rows = static_cast<const float*>(x);
  if (Cf::STREAM) {
    ln_matmul_f32_rows<<<(R + 7) / 8, 256, 0, st>>>(rows, static_cast<const float*>(gamma),
                                                    static_cast<const float*>(beta),
                                                    static_cast<float*>(scratch), R, C, eps);
    rows = static_cast<const float*>(scratch);
  }
  const int tiles_n = (N + Cf::BN - 1) / Cf::BN;
  const int tiles = (R + Cf::BM - 1) / Cf::BM * tiles_n;
  ln_matmul_f32<Cf><<<grid, Cf::THREADS, smem, st>>>(
      rows, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(w), static_cast<const float*>(wb), static_cast<float*>(out), R,
      C, N, eps, tiles_n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: wm (1 or 2), stages, grid and smem come from ops/ln_matmul.plan;
// geglu: w is [2N, C] and out [R, N] = h * gelu(gate) (EPI_GEGLU); fp32:
// wm is 1 when the rows stream (F32Cfg<true>), else 0; grid and smem come
// from ops/ln_matmul.plan_f32 (stages is ignored); scratch, [R, C] fp32,
// only when the rows stream; no geglu.  wb may be null.
extern "C" int ttv_ln_matmul(const void* x, const void* gamma, const void* beta,
                             const void* w, const void* wb, void* out, void* scratch, int R,
                             int C, int N, float eps, int is_bf16, int geglu, int wm, int stages,
                             int grid, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define TTV_LN_BF16(WM, EPI) \
  launch_bf16<WM, EPI>(x, gamma, beta, w, wb, out, R, C, N, eps, stages, grid, smem, st)
    if (wm == 2) return geglu ? TTV_LN_BF16(2, EPI_GEGLU) : TTV_LN_BF16(2, EPI_BIAS);
    if (wm == 1) return geglu ? TTV_LN_BF16(1, EPI_GEGLU) : TTV_LN_BF16(1, EPI_BIAS);
#undef TTV_LN_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (geglu) return (int)cudaErrorInvalidValue;
  if (wm == 0)
    return launch_f32<F32Cfg<false>>(x, gamma, beta, w, wb, out, scratch, R, C, N, eps, grid, smem, st);
  if (wm == 1)
    return launch_f32<F32Cfg<true>>(x, gamma, beta, w, wb, out, scratch, R, C, N, eps, grid, smem, st);
  return (int)cudaErrorInvalidValue;
}
