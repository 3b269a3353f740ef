// Building blocks of kernels D (attn_tail.cu) and G (ffn_block.cu): a
// tensor-core product tile with a fused epilogue, and the row kernels
// (LayerNorm forward and backward, column sums, ordered sums of partial
// results), for f32 or bf16 tensors.  Plain C interface through the
// sources; no PyTorch headers.
//
// Products.  C (M,N) = op(A) @ op(B) on mma.sync.m16n8k16 (bf16 operands,
// f32 sums) from ldmatrix fragments.  Layouts, all row-major in memory:
//   A_T = false: A is (M,K);  A_T = true: A is stored (K,M) (weight gradients)
//   B_T = false: B is (K,N);  B_T = true: B is stored (N,K)
// An operand reaches the tile as bf16 planes in device memory (TtOp), one
// or three by the arithmetic:
//   PL = 1 (bf16 tensors): the operand rounded to bf16, one product: JAX's
//     bf16 product (operands cast to the weights' type, f32 sums).  A bf16
//     tensor is its own plane; the f32 activations JAX casts (h1, dx2, dx1,
//     da) get a rounded copy from the pass that writes them.
//   PL = 3 (f32 tensors): the operand split x = hi + mid + lo, each bf16
//     (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): the 24
//     bits of an f32 value), and the six products whose terms reach 2^-16
//     of a product (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) summed in
//     f32; what is dropped is about 2^-24 of a term, f32's own rounding.
//     Each depth of 16 is summed afresh and added to the running sum by an
//     f32 add: the tensor cores truncate what they add to a sum, a bias
//     that grows with K.  (Two planes and three products, or the running
//     sum kept in the tensor cores, left gradient errors that moved
//     near-zero Adam updates past chip_smoke.py's train-step checks.)  The
//     pass that writes an activation writes its planes (beside its f32
//     value where a later step reads that); inputs and weights are split
//     by one split_kernel launch a call.
// So the tile itself only moves bf16: K runs in slices of 32 through a ring
// of shared-memory stages filled by cp.async (16-byte copies, as many
// slices in flight as the tile's budget holds), each tile keeps its global
// layout (the contiguous dimension stays contiguous, rows padded by 16
// bytes against bank conflicts), and ldmatrix or ldmatrix.trans turns it
// into the mma fragments: no layout needs a transposing copy.
// Tiles by the product's size (tt_plan): 128 x 128 tiles (8 warps of 64 x
// 32, two blocks an SM) from 2^28 multiply-adds on (pretrain's 16384 rows,
// the Longformer's 14336, a PPO update's 1500); below, the 64 x 32 tiles of
// the weight-streaming regime (4 warps of 16 x 32: a rollout state's 50
// rows), split along K until about two blocks an SM are in flight.  Large
// tiles split along K only up to one wave (the weight gradients, K = rows).
// A split product writes its raw K-slice sums, and tt_epi_kernel adds them
// in slice order and applies the epilogue: no atomics, every result
// bit-reproducible.
// Epilogue per element: + bias[n]; store to `pre`;
// gelu; x dropout mask of `site` (drop_scale, the same Philox bits); x
// gelu'(dgelu_x[m,n]); + resid[m,n]; store to `out` in its type and/or as
// the planes of a later product's operand.
//
// Dropout.  The TPU kernels drew their bits from the on-core PRNG per row
// tile; here every element's bits are Philox4x32-10 at counter (row,
// column, site, 0) under key (seed, PHILOX_KEY1), so a mask depends only on
// the absolute position, forward and backward see the same mask by
// construction, and ops/ffn_block.py draws the same bits in PyTorch.  Keep
// rule of the JAX kernels: top 24 bits x 2^-24 >= p, kept values x 1/(1-p).
//
// Operand dimensions: the contiguous one of each operand a multiple of 8
// (16-byte copies of bf16: the wrappers check D, DI); rows take any count
// (masked).

#pragma once

#include <type_traits>

#include "decode_layers.cuh"
#include "tc_mma.cuh"
#include "train_split.cuh"

namespace rlmg {

// Dropout multiplier of one element: 1/(1-p) if kept, else 0.
__device__ __forceinline__ float drop_scale(uint32_t seed, int site, int row, int col,
                                            float p, float inv) {
  const uint32_t bits = philox_first(seed, (uint32_t)row, (uint32_t)col, (uint32_t)site, 0u);
  return (float)(bits >> 8) * 5.9604644775390625e-08f >= p ? inv : 0.f;
}

// d/dx of the exact gelu: Phi(x) + x * phi(x).
__device__ __forceinline__ float dgelu(float x) {
  const float cdf = 0.5f * (1.f + erff(x * 0.7071067811865476f));
  return cdf + x * expf(-0.5f * x * x) * 0.3989422804014327f;
}

struct Drop {
  const int* seed;   // device pointer to the int32 seed (read in the kernel: no host sync)
  int site;          // 1, 2 or 3; 0 = no dropout
  float p, inv;      // rate and 1/(1-p) (computed on the host in double)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

using bf16 = __nv_bfloat16;

constexpr int TT_BK = 32, TT_PAD = 8;      // K slice; bf16 per smem row against bank conflicts
constexpr int TT_MAX_STAGES = 8;          // cp.async slices in flight, at most
constexpr int TT_SMS = 132;
constexpr int TT_MIN_KTILES = 4, TT_MAX_SPLIT = 16;
constexpr long long TT_LARGE_MACS = 1LL << 28;

template <int BM_, int BN_, int WM_, int WN_, int SMEM_, int MINB_>
struct TrainTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int SMEM = SMEM_;           // shared-memory budget of a block, bytes
  static constexpr int MINB = MINB_;           // blocks an SM the registers must allow
  static constexpr int THREADS = WM * WN * 32, WTM = BM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT % 2 == 0 && WTM % 16 == 0, "tile");
};
// two or more blocks an SM (228 KB of shared memory), each with a ring of
// 2 to 8 slices by its planes
using TTileS = TrainTile<64, 32, 4, 1, 96 * 1024, 1>;
using TTileL = TrainTile<128, 128, 2, 4, 114 * 1024, 2>;

// One operand's tile in shared memory: R rows of C bf16 (C along the
// global matrix's contiguous dimension), rows padded.
template <int R, int C>
struct SmemTile {
  static constexpr int ROWS = R, COLS = C, STRIDE = C + TT_PAD, ELEMS = R * STRIDE;
};

// A product's operand: its bf16 planes in device memory, row-major (hi,
// mid, lo; only hi for a bf16 tensor).
struct TtOp {
  const bf16* p[3];
};

// Copies rows [r0, r0 + ROWS) below rlim, columns [c0, c0 + COLS) below
// clim of the row-major bf16 matrix g (row length ld) into the tile dst;
// the rest is filled with zeros.
template <class S, int THREADS>
__device__ __forceinline__ void tile_load(bf16* dst, const bf16* __restrict__ g, int ld, int r0,
                                          int rlim, int c0, int clim, int tid) {
  constexpr int CPR = S::COLS / 8, N = S::ROWS * CPR / THREADS;
  static_assert(N * THREADS == S::ROWS * CPR, "copies");
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = tid + i * THREADS, r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    cp_async16(dst + r * S::STRIDE + c, ok ? g + (size_t)(r0 + r) * ld + c0 + c : g, ok);
  }
}

// The fused epilogue with typed tensors: TW
// the bias (a parameter), TC the output, TR the residual.
template <typename TW, typename TC, typename TR>
struct TcEpi {
  TC* out = nullptr;                 // may be null when `planes` takes the result
  TtPlanes planes;                   // the result as a later product's operand
  const TW* bias = nullptr;
  float* pre = nullptr;              // value after the bias, before the gelu
  int act = ACT_NONE;                // ACT_NONE or ACT_GELU
  Drop drop = {nullptr, 0, 0.f, 1.f};
  const float* dgelu_x = nullptr;
  const TR* resid = nullptr;
};

template <class E>
__device__ __forceinline__ float epi_value(const E& e, float v, int m, int n, size_t mn,
                                           uint32_t seed) {
  if (e.bias != nullptr) v += ld(e.bias + n);
  if (e.pre != nullptr) e.pre[mn] = v;
  if (e.act == ACT_GELU) v = gelu_exact(v);
  if (e.drop.site) v *= drop_scale(seed, e.drop.site, m, n, e.drop.p, e.drop.inv);
  if (e.dgelu_x != nullptr) v *= dgelu(e.dgelu_x[mn]);
  if (e.resid != nullptr) v += ld(e.resid + mn);
  return v;
}


// The epilogue of the pair (m, n), (m, n + 1) of sums v0, v1.
template <class E>
__device__ __forceinline__ void epi_pair(const E& e, float v0, float v1, int m, int n,
                                         size_t mn, uint32_t seed) {
  v0 = epi_value(e, v0, m, n, mn, seed);
  v1 = epi_value(e, v1, m, n + 1, mn + 1, seed);
  if (e.out != nullptr) st2(e.out + mn, v0, v1);
  if (e.planes.p[0] != nullptr) st_planes2(e.planes, mn, v0, v1);
}

// Shared-memory tile shapes of the two operands in their layouts.
template <class T, bool A_T>
using SmemA = std::conditional_t<A_T, SmemTile<TT_BK, T::BM>, SmemTile<T::BM, TT_BK>>;
template <class T, bool B_T>
using SmemB = std::conditional_t<B_T, SmemTile<T::BN, TT_BK>, SmemTile<TT_BK, T::BN>>;

// Shared memory of a product: a ring of STAGES slices, each the PL planes
// of A then those of B, as many as the tile's budget holds.
template <class T, bool A_T, bool B_T, int PL>
struct TtSmem {
  using SA = SmemA<T, A_T>;
  using SB = SmemB<T, B_T>;
  static constexpr int STAGE = PL * (SA::ELEMS + SB::ELEMS);     // bf16
  static constexpr int FIT = T::SMEM / (2 * STAGE);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > TT_MAX_STAGES ? TT_MAX_STAGES : FIT);
  static constexpr int BYTES = STAGES * STAGE * 2;
};

// Block (bx, by, bz): the tile (by, bx) of C over the K range [bz*kchunk,
// (bz+1)*kchunk).  part == nullptr: the epilogue e; else the raw sum to
// part[bz] (M,N) f32.
template <class T, bool A_T, bool B_T, int PL, class E>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
tt_gemm_kernel(TtOp A, TtOp B, int M, int N, int K, int kchunk, E e, float* __restrict__ part) {
  using L = TtSmem<T, A_T, B_T, PL>;
  using SA = typename L::SA;
  using SB = typename L::SB;
  extern __shared__ __align__(16) unsigned char tt_smem[];
  bf16* const sm = reinterpret_cast<bf16*>(tt_smem);   // [stage][A planes][B planes]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int nk = ke > kb ? (ke - kb + TT_BK - 1) / TT_BK : 0;

  auto fetch = [&](int st, int k0) {
    bf16* s = sm + st * L::STAGE;
#pragma unroll
    for (int pl = 0; pl < PL; ++pl) {
      if (A_T) tile_load<SA, T::THREADS>(s + pl * SA::ELEMS, A.p[pl], M, k0, ke, m0, M, tid);
      else tile_load<SA, T::THREADS>(s + pl * SA::ELEMS, A.p[pl], K, m0, M, k0, ke, tid);
      bf16* sb = s + PL * SA::ELEMS + pl * SB::ELEMS;
      if (B_T) tile_load<SB, T::THREADS>(sb, B.p[pl], K, n0, N, k0, ke, tid);
      else tile_load<SB, T::THREADS>(sb, B.p[pl], N, k0, ke, n0, N, tid);
    }
  };
  // fragments of m16 tile i / of the n16 pair p at depth kk (see tc_mma.cuh)
  auto frag_a = [&](uint32_t* r, const bf16* s, int i, int kk) {
    const int mb = wm * T::WTM + i * 16;
    if (A_T)
      ldmatrix_x4_trans(r, s + (kk + (lane & 7) + (lane >> 4) * 8) * SA::STRIDE + mb +
                               ((lane >> 3) & 1) * 8);
    else
      ldmatrix_x4(r, s + (mb + (lane & 15)) * SA::STRIDE + kk + (lane >> 4) * 8);
  };
  auto frag_b = [&](uint32_t* r, const bf16* s, int p, int kk) {
    const int nb = wn * T::WTN + p * 16;
    if (B_T)
      ldmatrix_x4(r, s + (nb + (lane & 7) + (lane >> 4) * 8) * SB::STRIDE + kk +
                         ((lane >> 3) & 1) * 8);
    else
      ldmatrix_x4_trans(r, s + (kk + (lane & 15)) * SB::STRIDE + nb + (lane >> 4) * 8);
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (st < nk) fetch(st, kb + st * TT_BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();       // slice t landed; slice t - 1's stage is free
    const int nt = t + L::STAGES - 1;
    if (nt < nk) fetch(nt % L::STAGES, kb + nt * TT_BK);
    cp_async_commit();
    const bf16* sa = sm + (t % L::STAGES) * L::STAGE;
    const bf16* sb = sa + PL * SA::ELEMS;
#pragma unroll
    for (int kk = 0; kk < TT_BK; kk += 16) {
      if (PL == 1) {
        uint32_t af[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) frag_a(af[i], sa, i, kk);
#pragma unroll
        for (int p = 0; p < T::NT / 2; ++p) {
          uint32_t bq[4];
          frag_b(bq, sb, p, kk);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            mma_bf16(acc[i][2 * p], af[i], &bq[0]);
            mma_bf16(acc[i][2 * p + 1], af[i], &bq[2]);
          }
        }
      } else {
        // planes 0, 1, 2 = hi, mid, lo; the six products of plane sums <= 2
#pragma unroll
        for (int p = 0; p < T::NT / 2; ++p) {
          uint32_t bq[3][4];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) frag_b(bq[pl], sb + pl * SB::ELEMS, p, kk);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            uint32_t aq[3][4];
#pragma unroll
            for (int pl = 0; pl < 3; ++pl) frag_a(aq[pl], sa + pl * SA::ELEMS, i, kk);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              // a fresh sum of this depth's products, then one rounded f32
              // add: the tensor cores truncate what they add to a running
              // sum, and over K / 16 steps that bias would pass f32's error
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              const int o = 2 * half;
              mma_bf16(c, aq[2], &bq[0][o]);
              mma_bf16(c, aq[0], &bq[2][o]);
              mma_bf16(c, aq[1], &bq[1][o]);
              mma_bf16(c, aq[1], &bq[0][o]);
              mma_bf16(c, aq[0], &bq[1][o]);
              mma_bf16(c, aq[0], &bq[0][o]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][2 * p + half][q] += c[q];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const uint32_t seed = (part == nullptr && e.drop.site) ? (uint32_t)*e.drop.seed : 0u;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int n = n0 + wn * T::WTN + j * 8 + t2;
      if (n >= N) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * T::WTM + i * 16 + g + hr * 8;
        if (m >= M) continue;
        const size_t mn = (size_t)m * N + n;
        const float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        if (part != nullptr) st2(part + (size_t)blockIdx.z * M * N + mn, v0, v1);
        else epi_pair(e, v0, v1, m, n, mn, seed);
      }
    }
}

// The split products' second pass: the s slices of part (M,N) added in
// slice order, then the epilogue; one thread a pair of columns.
template <class E>
__global__ void tt_epi_kernel(const float* __restrict__ part, int s, int M, int N, E e) {
  const size_t len = (size_t)M * N, i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  if (i >= len) return;
  float v0 = 0.f, v1 = 0.f;
  for (int z = 0; z < s; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(part + z * len + i);
    v0 += p.x;
    v1 += p.y;
  }
  const uint32_t seed = e.drop.site ? (uint32_t)*e.drop.seed : 0u;
  epi_pair(e, v0, v1, (int)(i / N), (int)(i % N), i, seed);
}

// CUDA launches issued by this library's host code since it was loaded
// (read by the C entries' rlmg_cuda_launches).
inline long long& tt_launches() {
  static long long n = 0;
  return n;
}

// How one product runs: its tile and its K split (s ranges of kchunk, a
// multiple of TT_BK).
struct TtPlan {
  int large, s, kchunk;
};

inline TtPlan tt_plan(int M, int N, int K) {
  const int large = (long long)M * N * K >= TT_LARGE_MACS;
  const int bm = large ? TTileL::BM : TTileS::BM, bn = large ? TTileL::BN : TTileS::BN;
  const int tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int ktiles = (K + TT_BK - 1) / TT_BK;
  int cap = ktiles / TT_MIN_KTILES;
  cap = cap < 1 ? 1 : (cap > TT_MAX_SPLIT ? TT_MAX_SPLIT : cap);
  int s = large ? TTileL::MINB * TT_SMS / tiles : (2 * TT_SMS + tiles - 1) / tiles;
  s = s < 1 ? 1 : (s > cap ? cap : s);
  const int kchunk = ((ktiles + s - 1) / s) * TT_BK;
  return {large, (K + kchunk - 1) / kchunk, kchunk};
}

// f32 scratch of a product's K-slice sums (0 when it is not split).
inline size_t tt_part_floats(int M, int N, int K) {
  const TtPlan p = tt_plan(M, N, K);
  return p.s > 1 ? (size_t)p.s * M * N : 0;
}

template <class T, bool A_T, bool B_T, int PL, class E>
int tt_launch(const TtOp& A, const TtOp& B, int M, int N, int K, const TtPlan& p, const E& e,
              float* part, cudaStream_t st) {
  constexpr int smem = TtSmem<T, A_T, B_T, PL>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)tt_gemm_kernel<T, A_T, B_T, PL, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, p.s);
  tt_gemm_kernel<T, A_T, B_T, PL, E><<<grid, T::THREADS, smem, st>>>(
      A, B, M, N, K, p.kchunk, e, p.s > 1 ? part : nullptr);
  ++tt_launches();
  RLMG_CHECK();
  return 0;
}

// C = op(A) @ op(B) with the epilogue e, on the tile and K split of
// tt_plan; PL planes an operand (3: the split arithmetic); part holds
// tt_part_floats(M, N, K).
template <bool A_T, bool B_T, int PL, class E>
int tt_gemm(const TtOp& A, const TtOp& B, int M, int N, int K, const E& e, float* part,
            cudaStream_t st) {
  const TtPlan p = tt_plan(M, N, K);
  const int rc = p.large ? tt_launch<TTileL, A_T, B_T, PL>(A, B, M, N, K, p, e, part, st)
                         : tt_launch<TTileS, A_T, B_T, PL>(A, B, M, N, K, p, e, part, st);
  if (rc || p.s == 1) return rc;
  const size_t pairs = (size_t)M * N / 2;
  tt_epi_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(part, p.s, M, N, e);
  ++tt_launches();
  RLMG_CHECK();
  return 0;
}

// Launches split_kernel on the jobs (none: nothing to split).
inline int split_all(const SplitJobs& jobs, cudaStream_t st) {
  if (jobs.count == 0) return 0;
  int n = 0;
  for (int i = 0; i < jobs.count; ++i) n = jobs.job[i].n > n ? jobs.job[i].n : n;
  split_kernel<<<dim3((n / 4 + 255) / 256, jobs.count), 256, 0, st>>>(jobs);
  ++tt_launches();
  RLMG_CHECK();
  return 0;
}

// -- ordered sums and column sums ---------------------------------------------

// out[i] = sum_{s < S} part[s * len + i], the slices added in order.
template <typename TO>
__global__ void reduce_parts_kernel(const float* __restrict__ part, int S, size_t len,
                                    TO* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[s * len + i];
  st(out + i, v);
}

template <typename TO>
int reduce_parts(const float* part, int S, size_t len, TO* out, cudaStream_t st) {
  reduce_parts_kernel<TO><<<(unsigned)((len + 255) / 256), 256, 0, st>>>(part, S, len, out);
  ++tt_launches();
  RLMG_CHECK();
  return 0;
}

constexpr int COLSUM_ROWS = 256;

__global__ void colsum_kernel(const float* __restrict__ x, float* __restrict__ part, int M,
                              int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * COLSUM_ROWS, r1 = min(M, r0 + COLSUM_ROWS);
  float v = 0.f;
  for (int r = r0; r < r1; ++r) v += x[(size_t)r * N + n];
  part[(size_t)blockIdx.y * N + n] = v;
}

inline size_t colsum_part_floats(int M, int N) {
  return (size_t)((M + COLSUM_ROWS - 1) / COLSUM_ROWS) * N;
}

// out (N) = sum over rows of x (M,N), in a fixed order.
template <typename TO>
int colsum(const float* x, TO* out, int M, int N, float* part, cudaStream_t st) {
  const int S = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_kernel<<<dim3((N + 255) / 256, S), 256, 0, st>>>(x, part, M, N);
  ++tt_launches();
  RLMG_CHECK();
  return reduce_parts(part, S, (size_t)N, out, st);
}

// -- LayerNorm, one warp per row ------------------------------------------------
//
// Lane l holds columns l, l+32, ... of its row in registers: NC values per
// lane, NC in {4, 8, 16, 32} chosen from D (D <= 1024).  Statistics and
// arithmetic in f32; the parameters (TS), the upstream gradient (TG) and
// the outputs are read and written in their own types.

constexpr int LN_WARPS = 8, LN_ROWS_PER_WARP = 16, LN_MAX_D = 1024;
constexpr float LN_EPS = 1e-5f;

// Mean and 1/std of one row held as v[i] = x[lane + 32 i].
template <int NC>
__device__ __forceinline__ void row_stats(const float (&v)[NC], int D, int lane, float& mu,
                                          float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (lane + 32 * i < D) s += v[i];
  mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (lane + 32 * i < D) q += (v[i] - mu) * (v[i] - mu);
  rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
}

// Launches of ln_fwd_kernel with `count` set that ran, counted by the
// kernel (block 0's thread 0), one counter a library: kernel G counts its
// forward's runs so (ffn_block.cu rlmg_ffn_runs), graph replays included.
__device__ unsigned long long tt_ln_runs;

// out = (x - mu) * rstd * scale + bias, per row; also as a product's
// operand planes when planes.p[0] is set.
template <int NC, typename TS, typename TO>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const float* __restrict__ x, const TS* __restrict__ scale,
              const TS* __restrict__ bias, TO* __restrict__ out, TtPlanes planes, int M, int D,
              int count) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (count && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&tt_ln_runs, 1ull);
  if (r >= M) return;
  const float* xr = x + (size_t)r * D;
  float v[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) v[i] = lane + 32 * i < D ? xr[lane + 32 * i] : 0.f;
  float mu, rstd;
  row_stats<NC>(v, D, lane, mu, rstd);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c >= D) continue;
    const float y = (v[i] - mu) * rstd * ld(scale + c) + ld(bias + c);
    st(out + (size_t)r * D + c, y);
    if (planes.p[0] != nullptr) st_planes(planes, (size_t)r * D + c, y);
  }
}

// LayerNorm backward, recomputing the statistics from the input x:
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dy * scale
// written to dx, and dx times the dropout mask `drop` to dxm (f32) and to
// its planes as a product's operand.  Each warp walks LN_ROWS_PER_WARP rows
// and writes its column sums of dy * xhat and dy to part (2 x warps x D),
// added in order by reduce_parts.
template <int NC, typename TG, typename TS, typename TX>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const float* __restrict__ x, const TG* __restrict__ dy,
              const TS* __restrict__ scale, TX* __restrict__ dx, float* __restrict__ dxm,
              TtPlanes planes, Drop drop, float* __restrict__ part, int M, int D, int n_warps) {
  const int lane = threadIdx.x & 31, w = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const uint32_t seed = drop.site ? (uint32_t)*drop.seed : 0u;
  float sc[NC], as[NC], ab[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    sc[i] = lane + 32 * i < D ? ld(scale + lane + 32 * i) : 0.f;
    as[i] = ab[i] = 0.f;
  }
  const int r1 = min(M, (w + 1) * LN_ROWS_PER_WARP);
  for (int r = w * LN_ROWS_PER_WARP; r < r1; ++r) {
    const size_t base = (size_t)r * D;
    float v[NC], g[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < D ? x[base + c] : 0.f;
      g[i] = c < D ? ld(dy + base + c) : 0.f;
    }
    float mu, rstd;
    row_stats<NC>(v, D, lane, mu, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      v[i] = (v[i] - mu) * rstd;                 // xhat (0 in the unused lanes' slots)
      const float dxh = g[i] * sc[i];
      s1 += dxh;
      s2 += dxh * v[i];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c >= D) continue;
      const float d = rstd * (g[i] * sc[i] - m1 - v[i] * m2);
      st(dx + base + c, d);
      const float dm = drop.site ? d * drop_scale(seed, drop.site, r, c, drop.p, drop.inv) : d;
      dxm[base + c] = dm;
      st_planes(planes, base + c, dm);
      as[i] += g[i] * v[i];
      ab[i] += g[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      part[(size_t)w * D + c] = as[i];
      part[((size_t)n_warps + w) * D + c] = ab[i];
    }
  }
}

template <typename TS, typename TO>
int ln_fwd(const float* x, const TS* scale, const TS* bias, TO* out, int M, int D,
           cudaStream_t st, TtPlanes planes = {}, int count = 0) {
  const int blocks = (M + LN_WARPS - 1) / LN_WARPS, th = LN_WARPS * 32;
  if (D <= 128) ln_fwd_kernel<4, TS, TO><<<blocks, th, 0, st>>>(x, scale, bias, out, planes, M, D, count);
  else if (D <= 256) ln_fwd_kernel<8, TS, TO><<<blocks, th, 0, st>>>(x, scale, bias, out, planes, M, D, count);
  else if (D <= 512) ln_fwd_kernel<16, TS, TO><<<blocks, th, 0, st>>>(x, scale, bias, out, planes, M, D, count);
  else ln_fwd_kernel<32, TS, TO><<<blocks, th, 0, st>>>(x, scale, bias, out, planes, M, D, count);
  ++tt_launches();
  RLMG_CHECK();
  return 0;
}

inline int ln_bwd_warps(int M) { return (M + LN_ROWS_PER_WARP - 1) / LN_ROWS_PER_WARP; }

inline size_t ln_bwd_part_floats(int M, int D) { return 2 * (size_t)ln_bwd_warps(M) * D; }

// dx, dxm (and dxm's planes) of the LayerNorm with input x, and its
// parameter gradients dscale, dbias (D each, in the parameters' type).
template <typename TG, typename TS, typename TX>
int ln_bwd(const float* x, const TG* dy, const TS* scale, TX* dx, float* dxm,
           const TtPlanes& planes, Drop drop, TS* dscale, TS* dbias, int M, int D, float* part,
           cudaStream_t st) {
  const int nw = ln_bwd_warps(M), blocks = (nw + LN_WARPS - 1) / LN_WARPS, th = LN_WARPS * 32;
  if (D <= 128) ln_bwd_kernel<4, TG, TS, TX><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, planes, drop, part, M, D, nw);
  else if (D <= 256) ln_bwd_kernel<8, TG, TS, TX><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, planes, drop, part, M, D, nw);
  else if (D <= 512) ln_bwd_kernel<16, TG, TS, TX><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, planes, drop, part, M, D, nw);
  else ln_bwd_kernel<32, TG, TS, TX><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, planes, drop, part, M, D, nw);
  ++tt_launches();
  RLMG_CHECK();
  int rc = reduce_parts(part, nw, (size_t)D, dscale, st);
  if (rc) return rc;
  return reduce_parts(part + (size_t)nw * D, nw, (size_t)D, dbias, st);
}

}  // namespace rlmg
