// K1: self-attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces this_and_that_vdm_tpu/ops/flash_attention.py::_kernel (launched by
// _flash_call).  The TPU kernel holds one whole fp32 [BQ, S] score tile in
// VMEM; a block here has at most 227 KB of shared memory, so it streams K/V
// in tiles with a running max and sum instead (the S x S scores never exist
// anywhere).
//
// Layout: q, k, v are [B, S, H, D] read through their strides (batch sb and
// row ss in elements; head stride D, unit stride inside a head), so the
// .chunk(3) views of a fused qkv product arrive without a copy; o is a
// contiguous [B, S, H, D].
//
// bf16 (the main path): wgmma + TMA.  One block of 288 threads per 128 query
// rows of one (batch, head): warpgroups 0 and 1 compute, 64 query rows each;
// warp 8 is the producer.  Its lane 0 loads the Q tile once, then streams K
// and V tiles (BK keys: 128 at D=64, 64 at D=128) through a ring of STAGES
// shared-memory stages, all by TMA with 4-D tensor maps over (D, H, S, B)
// into 128-byte-swizzled tiles; "full" mbarriers count the bytes in, "empty"
// ones count the 8 compute warps out.  Per tile a warpgroup runs
//   S = Q K^T    wgmma with both operands in shared memory, K-major;
//   softmax      online, in base 2 (ex2.approx), on the fp32 accumulators in
//                registers;
//   O += P V     wgmma with P from registers (the S accumulators rounded to
//                bf16 are the A fragments) and V as an MN-major B operand
//                read through the descriptor's transpose bit: no transposed
//                copy of V exists.
// S of tile j is issued together with P V of tile j-1, so the softmax of
// tile j runs while the tensor cores finish the previous product, and the
// two warpgroups take turns to issue (ping-pong) so that one's softmax
// overlaps the other's products.
// The output is divided by the fp32 row sum, rounded once and stored 16
// bytes a lane after a shuffle inside each quad.  A boundary box along S
// zero-fills (the 4-D map keeps it inside its batch); keys past S are masked
// to -inf and queries past S are not written, so any S works.
//
// fp32: a simpler kernel with plain FMAs through shared memory, so fp32 stays
// full fp32 (the tensor cores' tf32 would keep ~3 digits); it is the training
// path's comparison kernel, not the main path.
//
// Numerics (both): scores and the softmax statistics are fp32; P is rounded
// to V's dtype before P@V, which accumulates in fp32.
//
// Bound at the slice's shapes (S=1536, D=64, B*H=140, bf16): 4*B*H*S^2*D =
// 84.6 GFLOP against 2*4*B*S*H*D = 110 MB, i.e. tensor-core bound; the
// exp2 of every score (330 M on the multi-function units) costs about as
// much again, which is why the softmax is overlapped with the products.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ----------------------------------------------------------- bf16 path

constexpr int BQ = 128;            // query rows per block: two warpgroups of 64
constexpr int THREADS_BF16 = 288;  // warpgroups 0-1 compute, warp 8 produces
constexpr int STAGES = 4;          // K/V ring depth

template <int D>
struct Tiles {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int CB = D / 64;              // 64-wide (128-byte) column blocks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K (or V) tile
  // 1024 bytes of slack to align the tiles, Q, the ring, 1 + 2 * STAGES barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
    flash_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, int S, int H,
               float scale) {
  using T = Tiles<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hop::align1024(smem_raw);  // [CB][BQ rows][128 bytes]
  uint8_t* sKV = sQ + T::Q_BYTES;          // stage s: K then V, each [CB][BK rows][128 bytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + STAGES * 2 * T::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * BQ;
  const int nk = (S + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // one arrival per compute warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues every copy
    if (lane == 0) {
      hop::mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::CB; ++c)
        hop::tma_load_4d(sQ + c * BQ * 128, &mq, q_full, c * 64, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) hop::mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        uint8_t* sK = sKV + s * 2 * T::KV_BYTES;
        uint8_t* sV = sK + T::KV_BYTES;
        hop::mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < T::CB; ++c) {
          hop::tma_load_4d(sK + c * BK * 128, &mk, &full[s], c * 64, h, j * BK, b);
          hop::tma_load_4d(sV + c * BK * 128, &mv, &full[s], c * 64, h, j * BK, b);
        }
      }
    }
    return;
  }

  // compute warpgroup wg: query rows wg*64 .. +64; warp wl of it rows wl*16 ..
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2
  const uint8_t* qa = sQ + wg * 64 * 128;
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];  // rows g, g + 8
  float sc[BK / 2];  // index i: row g + 8 * ((i >> 1) & 1), key 8 * (i >> 2) + 2t + (i & 1)
  uint32_t pa[BK / 16][4];

  // S = Q K^T of tile j into sc (issued and committed, not awaited)
  auto issue_scores = [&](int j) {
    const uint8_t* sK = sKV + (j % STAGES) * 2 * T::KV_BYTES;
    hop::fence_acc(sc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;  // 16 columns inside the 128-byte row
      hop::wgmma_ss(sc, hop::desc(qa + (kk / 4) * BQ * 128 + off, 16, 1024),
                    hop::desc(sK + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
    }
    hop::wg_commit();
  };
  // O = alpha * O + P V of tile j (issued and committed, not awaited)
  auto issue_pv = [&](int j) {
    const uint8_t* sV = sKV + (j % STAGES) * 2 * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    hop::fence_acc(oacc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::wgmma_rs(oacc, pa[kk], hop::desc(sV + kk * 16 * 128, BK * 128, 1024), 1);
    hop::wg_commit();
  };
  // online softmax of tile j in place (sc -> exp2 of the scaled, shifted
  // scores), the new max in m, the rescale of the old sums in alpha
  auto softmax = [&](int j) {
    if ((j + 1) * BK > S) {  // the last tile runs past S
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (j * BK + 8 * (i >> 2) + 2 * t + (i & 1) >= S) sc[i] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]}, ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = hop::ex2((m[r] - mx[r]) * sl2);  // finite mx: every tile holds a key < S
      m[r] = mx[r];
      ms[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = hop::ex2(fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += sc[i];
    }
    // per-lane partial row sums: the quad's are added once, at the end
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  };
  // P, rounded to bf16, as the A fragments of P V (16 keys a step)
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hop::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  };

  // Tile j's softmax runs while the tensor cores do tile j-1's P V (FA3's
  // order): S_j and PV_{j-1} are issued together; S_j is awaited first.
  // The two warpgroups take turns to issue (named barriers 1 and 2, FA3's
  // ping-pong), so one's softmax overlaps the other's products.
  auto my_turn = [&]() { hop::named_sync(1 + wg, 256); };
  auto your_turn = [&]() { hop::named_arrive(2 - wg, 256); };
  if (wg == 1) your_turn();  // warpgroup 0 issues first
  hop::mbar_wait(q_full, 0);
  hop::mbar_wait(&full[0], 0);
  my_turn();
  issue_scores(0);
  your_turn();
  hop::wg_wait<0>();
  hop::fence_acc(sc);
  softmax(0);
  pack_p();
  for (int j = 1; j < nk; ++j) {
    hop::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    my_turn();
    issue_scores(j);
    issue_pv(j - 1);
    your_turn();
    hop::wg_wait<1>();  // S_j is in
    hop::fence_acc(sc);
    softmax(j);
    hop::wg_wait<0>();  // PV_{j-1} is in: its stage is free, pa may be overwritten
    hop::fence_acc(oacc);
    if (lane == 0) hop::mbar_arrive(&empty[(j - 1) % STAGES]);
    pack_p();
  }
  my_turn();
  issue_pv(nk - 1);
  if (wg == 0) your_turn();  // the last turn: every sync has had its arrival
  hop::wg_wait<0>();
  hop::fence_acc(oacc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const int row0 = q0 + wg * 64 + wl * 16 + g;
  bf16* ob = o + ((size_t)b * S * H + h) * D;
  const size_t orow = (size_t)H * D;
#pragma unroll
  for (int gr = 0; gr < D / 32; ++gr)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jb = 4 * gr + i;
        w[i] = hop::pack_bf16(oacc[4 * jb + 2 * hh] * inv[hh], oacc[4 * jb + 2 * hh + 1] * inv[hh]);
      }
      const uint4 u = hop::quad_transpose(w, t);
      const int row = row0 + 8 * hh;
      if (row < S) *reinterpret_cast<uint4*>(ob + row * orow + (4 * gr + t) * 8) = u;
    }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                long long sb, long long ss, float scale, cudaStream_t st) {
  using T = Tiles<D>;
  CUtensorMap mq, mk, mv;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t qbox[4] = {64, 1, BQ, 1}, kvbox[4] = {64, 1, (cuuint32_t)T::BK, 1};
  int err = hop::make_map(&mq, q, 4, dims, strides, qbox);
  if (!err) err = hop::make_map(&mk, k, 4, dims, strides, kvbox);
  if (!err) err = hop::make_map(&mv, v, 4, dims, strides, kvbox);
  if (err) return err;
  static const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_bf16<D><<<grid, THREADS_BF16, T::SMEM, st>>>(mq, mk, mv, static_cast<bf16*>(o), S, H,
                                                     scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- fp32 path

constexpr int FBQ = 64, FBK = 64, FTHREADS = 128;  // query rows, keys a tile, threads

template <int D>
struct F32Layout {
  static constexpr int LDT = D + 4;   // Q/K/V row stride
  static constexpr int LDS = FBK + 4;  // score / P row stride
  static constexpr size_t bytes =
      sizeof(float) * (3 * FBQ * LDT + FBQ * LDS + FBQ * LDT + 2 * FBQ);
};

template <int D>
__global__ void __launch_bounds__(FTHREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H,
              long long sb, long long ss, float scale) {
  using L = F32Layout<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + FBQ * L::LDT;
  float* sV = sK + FBK * L::LDT;
  float* sP = sV + FBK * L::LDT;  // scores, then probabilities
  float* sO = sP + FBQ * L::LDS;
  float* sM = sO + FBQ * L::LDT;
  float* sL = sM + FBQ;

  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * FBQ;
  const size_t row = (size_t)ss, orow = (size_t)H * D;
  const size_t base = (size_t)b * sb + (size_t)h * D, obase = ((size_t)b * S * H + h) * D;

  for (int i = tid; i < FBQ * D; i += FTHREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    sQ[r * L::LDT + c] = s < S ? q[base + s * row + c] : 0.f;
    sO[r * L::LDT + c] = 0.f;
  }
  for (int i = tid; i < FBQ; i += FTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  // lanes 2r, 2r+1 of a warp share query row r: 32 keys and D/2 outputs each
  const int r = (tid >> 5) * 16 + (lane >> 1), half = lane & 1;
  for (int k0 = 0; k0 < S; k0 += FBK) {
    __syncthreads();
    for (int i = tid; i < FBK * D; i += FTHREADS) {
      const int rr = i / D, c = i % D, s = k0 + rr;
      sK[rr * L::LDT + c] = s < S ? k[base + s * row + c] : 0.f;
      sV[rr * L::LDT + c] = s < S ? v[base + s * row + c] : 0.f;
    }
    __syncthreads();
    float* prow = sP + r * L::LDS + half * (FBK / 2);
    float mx = -INFINITY;
    for (int j = 0; j < FBK / 2; ++j) {
      const int key = half * (FBK / 2) + j;
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
    for (int j = 0; j < FBK / 2; ++j) {
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
      for (int j = 0; j < FBK; ++j) acc = fmaf(pr[j], sV[j * L::LDT + d], acc);
      sO[r * L::LDT + d] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < FBQ * D; i += FTHREADS) {
    const int rr = i / D, c = i % D, s = q0 + rr;
    if (s < S) o[obase + s * orow + c] = sO[rr * L::LDT + c] / sL[rr];
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               long long sb, long long ss, float scale, cudaStream_t st) {
  constexpr size_t bytes = F32Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + FBQ - 1) / FBQ, B * H);
  flash_f32<D><<<grid, FTHREADS, bytes, st>>>(static_cast<const float*>(q),
                                             static_cast<const float*>(k),
                                             static_cast<const float*>(v),
                                             static_cast<float*>(o), S, H, sb, ss, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with batch stride sb and row stride ss (elements),
// head stride D, unit stride; bf16 also needs 16-byte-aligned bases and sb,
// ss multiples of 8 (the wrapper checks).  o: contiguous [B, S, H, D].
extern "C" int ttv_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int H, int D, long long sb, long long ss,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? launch_bf16<64>(q, k, v, o, B, S, H, sb, ss, scale, st)
                   : launch_f32<64>(q, k, v, o, B, S, H, sb, ss, scale, st);
  if (D == 128)
    return is_bf16 ? launch_bf16<128>(q, k, v, o, B, S, H, sb, ss, scale, st)
                   : launch_f32<128>(q, k, v, o, B, S, H, sb, ss, scale, st);
  return (int)cudaErrorInvalidValue;
}
