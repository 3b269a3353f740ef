// Building blocks of the SIMT training kernels (attention_block.cu,
// window_attention.cu, causal_product.cu): a register-blocked tiled GEMM
// with fused epilogues (kernel C's qkv projection) and 4x4 outer products
// from shared memory; the dropout rule and gelu' that kernels D and G share
// (their tensor-core products: train_gemm_tc.cuh).  Plain C interface
// through the sources; no PyTorch headers.
//
// GEMM.  C (M,N) = op(A) @ op(B), f32 accumulation, inputs read as float or
// bf16.  A block of 256 threads owns a 128x128 tile of C; each thread keeps
// an 8x8 sub-tile in registers (rows ty*4+i and 64+ty*4+i, columns tx*4+j
// and 64+tx*4+j), and the K loop walks 16-deep slices through two shared-
// memory buffers (the next slice is read into registers while the current
// one is multiplied).  Layouts, all row-major in memory:
//   A_T = false: A is (M,K);  A_T = true: A is stored (K,M) and read transposed
//   B_T = false: B is (K,N);  B_T = true: B is stored (N,K) and read transposed
// Every global read is 16 bytes (4 values) along the contiguous dimension,
// so that dimension must be a multiple of 4 (the wrappers check it).
// Epilogue per element, in this order: + bias[n]; store the value to `pre`;
// activation (gelu, or phi on the first phi_cols columns); x dropout mask
// of `site`; x gelu'(dgelu_x[m,n]); + resid[m,n]; store to `out`.  With
// `part` set the block instead writes its raw K-slice sum to part[z] and a
// second pass adds the slices in a fixed order (no atomics: every result is
// bit-reproducible).  f32 FMAs, no tensor cores.
//
// Dropout.  The TPU kernels drew their bits from the on-core PRNG per row
// tile; here every element's bits are Philox4x32-10 at counter (row,
// column, site, 0) under key (seed, PHILOX_KEY1), so a mask depends only on
// the absolute position, forward and backward see the same mask by
// construction, and ops/ffn_block.py draws the same bits in PyTorch.  Keep
// rule of the JAX kernels: top 24 bits x 2^-24 >= p, kept values x 1/(1-p).

#pragma once

#include "decode_layers.cuh"

namespace rlmg {

constexpr int GM = 128, GN = 128, GK = 16, GEMM_THREADS = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

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

template <typename TB, typename TC>
struct Epi {
  TC* out = nullptr;
  const TB* bias = nullptr;
  float* pre = nullptr;              // value after the bias, before the activation
  int act = ACT_NONE, phi_cols = 0;
  Drop drop = {nullptr, 0, 0.f, 1.f};
  const float* dgelu_x = nullptr;
  const float* resid = nullptr;
  float* part = nullptr;             // K-split partial sums (the rest is then unused)
};

template <bool A_T, bool B_T, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_tile_kernel(const TA* __restrict__ A, const TB* __restrict__ B, int M, int N, int K,
                 int kchunk, Epi<TB, TC> e) {
  __shared__ __align__(16) float As[2][GK][GM];
  __shared__ __align__(16) float Bs[2][GK][GN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[2], rb[2];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      if (!A_T) {   // 128 rows x 4 vectors of k
        const int m = m0 + (v >> 2), k = k0 + (v & 3) * 4;
        ra[i] = (m < M && k < ke) ? ld4(A + (size_t)m * K + k) : zero;
      } else {      // 16 k rows x 32 vectors of m
        const int m = m0 + (v & 31) * 4, k = k0 + (v >> 5);
        ra[i] = (m < M && k < ke) ? ld4(A + (size_t)k * M + m) : zero;
      }
      if (!B_T) {   // 16 k rows x 32 vectors of n
        const int n = n0 + (v & 31) * 4, k = k0 + (v >> 5);
        rb[i] = (n < N && k < ke) ? ld4(B + (size_t)k * N + n) : zero;
      } else {      // 128 n rows x 4 vectors of k
        const int n = n0 + (v >> 2), k = k0 + (v & 3) * 4;
        rb[i] = (n < N && k < ke) ? ld4(B + (size_t)n * K + k) : zero;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * GEMM_THREADS;
      if (!A_T) {
        const int r = v >> 2, kq = (v & 3) * 4;
        As[buf][kq][r] = ra[i].x;
        As[buf][kq + 1][r] = ra[i].y;
        As[buf][kq + 2][r] = ra[i].z;
        As[buf][kq + 3][r] = ra[i].w;
      } else {
        *reinterpret_cast<float4*>(&As[buf][v >> 5][(v & 31) * 4]) = ra[i];
      }
      if (!B_T) {
        *reinterpret_cast<float4*>(&Bs[buf][v >> 5][(v & 31) * 4]) = rb[i];
      } else {
        const int r = v >> 2, kq = (v & 3) * 4;
        Bs[buf][kq][r] = rb[i].x;
        Bs[buf][kq + 1][r] = rb[i].y;
        Bs[buf][kq + 2][r] = rb[i].z;
        Bs[buf][kq + 3][r] = rb[i].w;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = ke > kb ? (ke - kb + GK - 1) / GK : 0;
  if (nk > 0) {
    load(kb);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load(kb + (t + 1) * GK);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  const uint32_t seed = (e.part == nullptr && e.drop.site) ? (uint32_t)*e.drop.seed : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 60 + ty * 4 + i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 60 + tx * 4 + j);
      if (n >= N) continue;
      const size_t mn = (size_t)m * N + n;
      float v = acc[i][j];
      if (e.part != nullptr) {
        e.part[(size_t)blockIdx.z * M * N + mn] = v;
        continue;
      }
      if (e.bias != nullptr) v += ld(e.bias + n);
      if (e.pre != nullptr) e.pre[mn] = v;
      v = activate(v, e.act, n, e.phi_cols);
      if (e.drop.site) v *= drop_scale(seed, e.drop.site, m, n, e.drop.p, e.drop.inv);
      if (e.dgelu_x != nullptr) v *= dgelu(e.dgelu_x[mn]);
      if (e.resid != nullptr) v += e.resid[mn];
      st(e.out + mn, v);
    }
  }
}

// C = op(A) @ op(B) with the epilogue e, no K split.
template <bool A_T, bool B_T, typename TA, typename TB, typename TC>
int gemm(const TA* A, const TB* B, int M, int N, int K, const Epi<TB, TC>& e, cudaStream_t st) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, 1);
  gemm_tile_kernel<A_T, B_T, TA, TB, TC><<<grid, GEMM_THREADS, 0, st>>>(A, B, M, N, K, K, e);
  RLMG_CHECK();
  return 0;
}

// Register-blocked outer products from shared memory (the attention kernels):
// acc[i][j] += sum_{k < K} X[k * ldx + r0 + i] * Y[k * ldy + c0 + j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float* X, int ldx, int r0,
                                       const float* Y, int ldy, int c0, int K) {
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(X + k * ldx + r0);
    const float4 b = *reinterpret_cast<const float4*>(Y + k * ldy + c0);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero4(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rlmg
