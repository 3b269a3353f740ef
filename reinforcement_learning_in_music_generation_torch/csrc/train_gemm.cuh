// Building blocks of the training kernels (attention_block.cu, attn_tail.cu,
// window_attention.cu): a register-blocked tiled GEMM with fused epilogues,
// 4x4 outer products from shared memory, row-wise LayerNorm forward and
// backward, and deterministic column sums.  Plain C interface
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
// bit-reproducible).  No tensor cores yet (wgmma comes in a later change).
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
constexpr int GEMM_TARGET_BLOCKS = 528;    // 2 resident blocks x 132 SMs x 2

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

// out[i] = sum_{s < S} part[s * len + i], the slices added in order.
__global__ void reduce_parts_kernel(const float* __restrict__ part, int S, size_t len,
                                    float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float v = 0.f;
  for (int s = 0; s < S; ++s) v += part[s * len + i];
  out[i] = v;
}

inline int reduce_parts(const float* part, int S, size_t len, float* out, cudaStream_t st) {
  reduce_parts_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(part, S, len, out);
  RLMG_CHECK();
  return 0;
}

// C = op(A) @ op(B) with the epilogue e, no K split.
template <bool A_T, bool B_T, typename TA, typename TB, typename TC>
int gemm(const TA* A, const TB* B, int M, int N, int K, const Epi<TB, TC>& e, cudaStream_t st) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, 1);
  gemm_tile_kernel<A_T, B_T, TA, TB, TC><<<grid, GEMM_THREADS, 0, st>>>(A, B, M, N, K, K, e);
  RLMG_CHECK();
  return 0;
}

// K split of a weight-gradient product X^T @ dY, whose K is the row count.
struct TnSplit {
  int s, kchunk;
};

inline TnSplit tn_split(int M, int N, int K) {
  const int tiles = ((M + GM - 1) / GM) * ((N + GN - 1) / GN);
  const int ktiles = (K + GK - 1) / GK;
  int s = (GEMM_TARGET_BLOCKS + tiles - 1) / tiles;
  s = s < 1 ? 1 : (s > ktiles ? ktiles : s);
  const int kchunk = ((ktiles + s - 1) / s) * GK;
  return {(K + kchunk - 1) / kchunk, kchunk};
}

inline size_t tn_part_floats(int M, int N, int K) {
  return (size_t)tn_split(M, N, K).s * M * N;
}

// out (M,N) = X^T @ dY with X (K,M) and dY (K,N) f32: K-split partial sums
// into part (tn_part_floats), then one ordered reduction.
inline int gemm_tn(const float* X, const float* dY, float* out, int M, int N, int K, float* part,
                   cudaStream_t st) {
  const TnSplit sp = tn_split(M, N, K);
  Epi<float, float> e;
  e.part = part;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, sp.s);
  gemm_tile_kernel<true, false, float, float, float><<<grid, GEMM_THREADS, 0, st>>>(
      X, dY, M, N, K, sp.kchunk, e);
  RLMG_CHECK();
  return reduce_parts(part, sp.s, (size_t)M * N, out, st);
}

// -- column sums ------------------------------------------------------------

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
inline int colsum(const float* x, float* out, int M, int N, float* part, cudaStream_t st) {
  const int S = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_kernel<<<dim3((N + 255) / 256, S), 256, 0, st>>>(x, part, M, N);
  RLMG_CHECK();
  return reduce_parts(part, S, (size_t)N, out, st);
}

// -- LayerNorm, one warp per row ------------------------------------------------
//
// Lane l holds columns l, l+32, ... of its row in registers: NC values per
// lane, NC in {4, 8, 16, 32} chosen from D (D <= 1024).

constexpr int LN_WARPS = 8, LN_ROWS_PER_WARP = 16, LN_MAX_D = 1024;
constexpr float LN_EPS = 1e-5f;

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

// out = (x - mu) * rstd * scale + bias, per row.
template <int NC>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ out, int M, int D) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
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
    if (c < D) out[(size_t)r * D + c] = (v[i] - mu) * rstd * scale[c] + bias[c];
  }
}

// LayerNorm backward, recomputing the statistics from the input x:
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dy * scale
// written to dx, and dx times the dropout mask `drop` to dxm.  Each warp
// walks LN_ROWS_PER_WARP rows and writes its column sums of dy * xhat and dy
// to part (2 x warps x D), added in order by reduce_parts.
template <int NC>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ scale, float* __restrict__ dx, float* __restrict__ dxm,
              Drop drop, float* __restrict__ part, int M, int D, int n_warps) {
  const int lane = threadIdx.x & 31, w = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (w >= n_warps) return;
  const uint32_t seed = drop.site ? (uint32_t)*drop.seed : 0u;
  float sc[NC], as[NC], ab[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    sc[i] = lane + 32 * i < D ? scale[lane + 32 * i] : 0.f;
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
      g[i] = c < D ? dy[base + c] : 0.f;
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
      dx[base + c] = d;
      if (dxm != nullptr)
        dxm[base + c] = drop.site ? d * drop_scale(seed, drop.site, r, c, drop.p, drop.inv) : d;
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

inline int ln_fwd(const float* x, const float* scale, const float* bias, float* out, int M, int D,
                  cudaStream_t st) {
  const int blocks = (M + LN_WARPS - 1) / LN_WARPS;
  if (D <= 128) ln_fwd_kernel<4><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, out, M, D);
  else if (D <= 256) ln_fwd_kernel<8><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, out, M, D);
  else if (D <= 512) ln_fwd_kernel<16><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, out, M, D);
  else ln_fwd_kernel<32><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, out, M, D);
  RLMG_CHECK();
  return 0;
}

inline int ln_bwd_warps(int M) { return (M + LN_ROWS_PER_WARP - 1) / LN_ROWS_PER_WARP; }

inline size_t ln_bwd_part_floats(int M, int D) { return 2 * (size_t)ln_bwd_warps(M) * D; }

// dx (and dxm) of the LayerNorm with input x, and its parameter gradients
// dscale, dbias (D each).
inline int ln_bwd(const float* x, const float* dy, const float* scale, float* dx, float* dxm,
                  Drop drop, float* dscale, float* dbias, int M, int D, float* part,
                  cudaStream_t st) {
  const int nw = ln_bwd_warps(M), blocks = (nw + LN_WARPS - 1) / LN_WARPS, th = LN_WARPS * 32;
  if (D <= 128) ln_bwd_kernel<4><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, drop, part, M, D, nw);
  else if (D <= 256) ln_bwd_kernel<8><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, drop, part, M, D, nw);
  else if (D <= 512) ln_bwd_kernel<16><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, drop, part, M, D, nw);
  else ln_bwd_kernel<32><<<blocks, th, 0, st>>>(x, dy, scale, dx, dxm, drop, part, M, D, nw);
  RLMG_CHECK();
  int rc = reduce_parts(part, nw, (size_t)D, dscale, st);
  if (rc) return rc;
  return reduce_parts(part + (size_t)nw * D, nw, (size_t)D, dbias, st);
}

}  // namespace rlmg
