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
// fp32 (the training path: the trainable GestureNet and the VL UNet are
// fp32): both products on the tensor cores in 3xTF32 (hopper.cuh), so the
// result keeps fp32 accuracy (one TF32 product keeps ~3 digits; three keep
// ~2^-21).  wgmma takes TF32 operands from shared memory only K-major, which
// fits K in Q K^T but not V in P V (V is [keys, D], MN-major; the transpose
// bit exists only for 16-bit types), and each operand needs its hi / lo
// halves.  So this path is built on mma.sync m16n8k8 with the split done in
// registers as each fragment is loaded, fed by a cp.async ring:
//   - 256 threads, 128 query rows a block (16 a warp), BK = 64 keys a tile;
//     Q is copied once into shared memory, K and V stream through a ring of
//     two stages with cp.async, the load of tile j + 1 in flight while tile
//     j computes; at D = 64 two blocks share an SM;
//   - S = Q K^T: the fragments are read 8 bytes a lane, because the k index
//     of the product is mapped to head columns (2t, 2t + 1) for both Q and K;
//     each of the three products runs over all 8 key blocks before the
//     next, so consecutive mma.sync are independent;
//   - softmax: online, in base 2 (ex2.approx with the scale folded in), on
//     the score accumulators in registers;
//   - O += P V: the score accumulators are the A fragments as they lie,
//     with the product's k index mapped to keys (2t, 2t + 1) -- the order of
//     a sum over keys is free -- and V read with the same map; the O
//     accumulator stays in registers for the whole key loop.
//   Row strides of D + 8 (Q, K) and D + 4 (V) floats make every fragment
//   load free of bank conflicts.  Keys past S are zero-filled by cp.async
//   and masked to -inf; queries past S are zero and not written.
//
// Numerics (both): scores and the softmax statistics are fp32; P is rounded
// to V's dtype before P@V, which accumulates in fp32.
//
// Bound at the slice's shapes (S=1536, D=64, B*H=140): 4*B*H*S^2*D =
// 84.6 GFLOP against 2*4*B*S*H*D = 110 MB in bf16, i.e. tensor-core bound;
// the exp2 of every score (330 M on the multi-function units) costs about as
// much again, which is why the bf16 path overlaps the softmax with the
// products.  In fp32 the three TF32 products run at a third of 495 TFLOP/s,
// and the hi / lo splits (a few ALU operations per fragment element) compete
// with the products for issue slots.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
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
  static ttv::PerDevice allowed;
  const cudaError_t e =
      ttv::allow_smem(reinterpret_cast<const void*>(flash_bf16<D>), T::SMEM, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_bf16<D><<<grid, THREADS_BF16, T::SMEM, st>>>(mq, mk, mv, static_cast<bf16*>(o), S, H,
                                                     scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- fp32 path

constexpr int FBQ = 128, FBK = 64, FTHREADS = 256;  // query rows, keys a tile, threads

// K/V ring depth 2: at D = 64 two blocks fit an SM (106 KB each), which
// measured faster than one block with a deeper ring
template <int D>
struct F32Tiles {
  static constexpr int STAGES = 2, MINB = D == 64 ? 2 : 1;  // MINB: blocks an SM holds
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = D + 4;  // row strides in floats
  static constexpr int Q_FLOATS = FBQ * LDQ;
  static constexpr int STAGE_FLOATS = FBK * (LDK + LDV);  // K then V
  static constexpr int SMEM = 4 * (Q_FLOATS + STAGES * STAGE_FLOATS);
};

// the A fragment (hi, lo) of rows g, g + 8 of a 16-row Q slice at k step kk
template <int LDQ>
__device__ __forceinline__ void q_frag(const float* qw, int kk, int g, int t, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(qw + g * LDQ + 8 * kk + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(qw + (g + 8) * LDQ + 8 * kk + 2 * t);
  hop::split_tf32(x0.x, ah[0], al[0]);
  hop::split_tf32(x1.x, ah[1], al[1]);
  hop::split_tf32(x0.y, ah[2], al[2]);
  hop::split_tf32(x1.y, ah[3], al[3]);
}

// d[n0 + n] += a * b[n] for n < NB in 3xTF32, each of the three products
// over every n before the next, so that consecutive mma.sync are independent
template <int NB, int ND>
__device__ __forceinline__ void mma3_row(float (&d)[ND][4], int n0, const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[NB][2],
                                         const uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) hop::mma_tf32(d[n0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NB; ++n) hop::mma_tf32(d[n0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NB; ++n) hop::mma_tf32(d[n0 + n], ah, bh[n][0], bh[n][1]);
}

template <int D>
__global__ void __launch_bounds__(FTHREADS, F32Tiles<D>::MINB)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H,
              long long sb, long long ss, float scale) {
  using T = F32Tiles<D>;
  constexpr int LDQ = T::LDQ, LDK = T::LDK, LDV = T::LDV, STAGES = T::STAGES;
  constexpr int CPR = D / 4;    // 16-byte pieces of a row
  constexpr int NB = FBK / 8;   // key blocks of 8 in a tile
  constexpr int DB = D / 8;     // column blocks of 8 in a row
  constexpr int VB = DB < 8 ? DB : 8;  // V column blocks split at once
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);  // [FBQ][LDQ]
  float* sKV = sQ + T::Q_FLOATS;                  // stage s: K [FBK][LDK], V [FBK][LDV]

  const int b = blockIdx.y / H, h = blockIdx.y % H, q0 = blockIdx.x * FBQ;
  const int nk = (S + FBK - 1) / FBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)b * sb + (size_t)h * D;  // row s of q, k, v at base + s * ss

  for (int i = tid; i < FBQ * CPR; i += FTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 4, s = q0 + r;
    hop::cp_async16(sQ + r * LDQ + c, q + base + (size_t)min(s, S - 1) * ss + c, s < S);
  }
  auto load_kv = [&](int j) {
    float* sK = sKV + (j % STAGES) * T::STAGE_FLOATS;
    float* sV = sK + FBK * LDK;
    for (int i = tid; i < FBK * CPR; i += FTHREADS) {
      const int r = i / CPR, c = (i % CPR) * 4, s = j * FBK + r;
      const size_t off = base + (size_t)min(s, S - 1) * ss + c;
      hop::cp_async16(sK + r * LDK + c, k + off, s < S);
      hop::cp_async16(sV + r * LDV + c, v + off, s < S);
    }
  };
  // group 0 holds Q and tile 0; group i tile i
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nk) load_kv(j);
    hop::cp_async_commit();
  }

  const float sl2 = scale * 1.4426950408889634f;  // softmax in base 2
  const float* qw = sQ + warp * 16 * LDQ;          // this warp's 16 query rows
  float oacc[DB][4];  // [column block n][element]: rows g, g + 8; columns 8n + 2t, +1
  float sc[NB][4];    // [key block n][element]: rows g, g + 8; keys 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < DB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j = 0; j < nk; ++j) {
    hop::cp_async_wait<STAGES - 2>();  // tile j (and Q) landed for this thread...
    __syncthreads();                   // ...and for every thread; stage (j - 1) is free
    if (j + STAGES - 1 < nk) load_kv(j + STAGES - 1);
    hop::cp_async_commit();
    const float* sK = sKV + (j % STAGES) * T::STAGE_FLOATS;
    const float* sV = sK + FBK * LDK;

    // S = Q K^T, k step kk over head columns 8kk + (2t, 2t + 1)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DB; ++kk) {
      uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
      q_frag<LDQ>(qw, kk, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(sK + (8 * n + g) * LDK + 8 * kk + 2 * t);
        hop::split_tf32(y.x, bh[n][0], bl[n][0]);
        hop::split_tf32(y.y, bh[n][1], bl[n][1]);
      }
      mma3_row<NB>(sc, 0, ah, al, bh, bl);
    }

    // online softmax of the tile: sc -> 2^(scaled score - row max)
    if ((j + 1) * FBK > S) {  // the last tile runs past S
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * FBK + 8 * n + 2 * t + (e & 1) >= S) sc[n][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]}, ms[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = hop::ex2((m[r] - mx[r]) * sl2);  // finite mx: every tile holds a key < S
      m[r] = mx[r];
      ms[r] = mx[r] * sl2;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = hop::ex2(fmaf(sc[n][e], sl2, -ms[e >> 1]));
        sum[e >> 1] += sc[n][e];
      }
    // per-lane partial row sums: the quad's are added once, at the end
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int n = 0; n < DB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e >> 1];

    // O += P V, k step kk over keys 8kk + (2t, 2t + 1): the A fragment is
    // (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) = sc[kk][0, 2, 1, 3]
#pragma unroll
    for (int kk = 0; kk < NB; ++kk) {
      uint32_t ph[4], pl[4];
      hop::split_tf32(sc[kk][0], ph[0], pl[0]);
      hop::split_tf32(sc[kk][2], ph[1], pl[1]);
      hop::split_tf32(sc[kk][1], ph[2], pl[2]);
      hop::split_tf32(sc[kk][3], ph[3], pl[3]);
      const float* v0 = sV + (8 * kk + 2 * t) * LDV + g;
#pragma unroll
      for (int n0 = 0; n0 < DB; n0 += VB) {
        uint32_t bh[VB][2], bl[VB][2];
#pragma unroll
        for (int n = 0; n < VB; ++n) {
          hop::split_tf32(v0[8 * (n0 + n)], bh[n][0], bl[n][0]);
          hop::split_tf32(v0[LDV + 8 * (n0 + n)], bh[n][1], bl[n][1]);
        }
        mma3_row<VB>(oacc, n0, ph, pl, bh, bl);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const size_t orow = (size_t)H * D;
  float* ob = o + ((size_t)b * S * H + h) * D + 2 * t;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row < S)
#pragma unroll
      for (int n = 0; n < DB; ++n)
        *reinterpret_cast<float2*>(ob + row * orow + 8 * n) =
            make_float2(oacc[n][2 * hh] * inv[hh], oacc[n][2 * hh + 1] * inv[hh]);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               long long sb, long long ss, float scale, cudaStream_t st) {
  constexpr int smem = F32Tiles<D>::SMEM;
  static ttv::PerDevice allowed;
  const cudaError_t e =
      ttv::allow_smem(reinterpret_cast<const void*>(flash_f32<D>), smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + FBQ - 1) / FBQ, B * H);
  flash_f32<D><<<grid, FTHREADS, smem, st>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v),
                                            static_cast<float*>(o), S, H, sb, ss, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, D] with batch stride sb and row stride ss (elements),
// head stride D, unit stride, 16-byte-aligned bases and sb, ss multiples of
// 8 (the wrapper checks; fp32 cp.async needs multiples of 4).  o: contiguous [B, S, H, D].
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
