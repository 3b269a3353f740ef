// qkv projection + chunked causal linear attention, forward and backward:
// the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/attention_block.py
// qkv_attention_block (its Pallas bodies _fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel).
//
// Forward: one GEMM (train_gemm.cuh) writes pqkv = [phi(q) | phi(k) | v]
// with the bias and phi = elu+1 in its epilogue; pqkv is the backward
// residual, as on the TPU.  Then attn_fwd_kernel runs one block per
// (sequence, head) that walks the sequence in tiles of AT_T = 64 rows with
// the running state S = sum phi(k) v^T (E x E) and z = sum phi(k) in shared
// memory, in place of the TPU's sequential grid axis:
//   A = tril(q k^T),  num = A v + q S,  den = rowsum(A) + q.z,
//   att = num / (den + eps),  then S += k^T v, z += colsum(k).
// The tile length is a numerics-free choice (any tiling of the causal sum
// gives the same result up to rounding); the wrapper still checks the
// caller's chunk against the sequence length, as the TPU kernel does.
// Backward, two kernels over the same blocks (the TPU's two passes):
//   attn_bwd_dq_kernel   tiles in order with prefix (S, z):  d phi(q)
//   attn_bwd_dkv_kernel  tiles in reverse with suffix (G, gz): d phi(k), dv
// with dnum = g / (den + eps), dd = -sum(g * att) / (den + eps), and phi'
// recovered from the stored phi as min(phi, 1).  They write dqkv (N, 3D);
// dh = dqkv W^T, dW = h^T dqkv and db stay outside, as on the TPU.
// The TPU kernel packed two heads per program and masked half-lanes to
// fill 128-lane rows; that has no purpose here and is dropped.
//
// Bound on the card (PERF.md).  At N = 16384 rows, D = 512, 8 heads of 64:
// the projection is 2 N D 3D = 25.8 GFLOP and the attention 3.2 GFLOP (the
// causal half of each score tile), and the forward moves ~0.2 GB, so
// operations bind (about 0.43 ms at 67 TFLOP/s, f32 outside the tensor
// cores).  What the design does about it: the qkv
// product is a register-blocked tile GEMM; every attention product is a 4x4
// register-blocked outer product from shared memory, and the (C, C) score
// tiles and the states never leave shared memory.  No tensor cores yet.

#include "train_gemm.cuh"

namespace rlmg {

constexpr int AT_T = 64, AT_THREADS = 256, AT_MAX_E = 64;

inline size_t fwd_smem_floats(int E) {
  return 4 * (size_t)E * AT_T + AT_T * AT_T + E * E + E + AT_T;
}
inline size_t dq_smem_floats(int E) { return fwd_smem_floats(E); }
inline size_t dkv_smem_floats(int E) {
  return 6 * (size_t)E * AT_T + AT_T * AT_T + 2 * E * E + E + AT_T;
}

// Block (head h, sequence b).  pqkv (N, 3D) = [phi(q) | phi(k) | v];
// att (N, D); den (N, H) f32.  S rows per sequence.
template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
attn_fwd_kernel(const T* __restrict__ pqkv, T* __restrict__ att, float* __restrict__ den,
                int S, int D, int H, int E, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* qT = sm;                    // E x T
  float* kT = qT + E * AT_T;         // E x T
  float* k = kT + E * AT_T;          // T x E
  float* v = k + AT_T * E;           // T x E
  float* AT = v + AT_T * E;          // T x T, AT[j][i] = A[i][j]
  float* Sm = AT + AT_T * AT_T;      // E x E
  float* z = Sm + E * E;             // E
  float* dn = z + E;                 // T
  for (int i = tid; i < E * E; i += AT_THREADS) Sm[i] = 0.f;
  for (int i = tid; i < E; i += AT_THREADS) z[i] = 0.f;
  const int E4 = E / 4, T4 = AT_T / 4;
  const size_t D3 = 3 * (size_t)D;
  for (int t0 = 0; t0 < S; t0 += AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float qv = 0.f, kv = 0.f, vv = 0.f;
      if (i < nv) {
        const T* row = pqkv + ((size_t)b * S + t0 + i) * D3 + h * E + e;
        qv = ld(row);
        kv = ld(row + D);
        vv = ld(row + 2 * D);
      }
      qT[e * AT_T + i] = qv;
      kT[e * AT_T + i] = kv;
      k[i * E + e] = kv;
      v[i * E + e] = vv;
    }
    __syncthreads();
    for (int blk = tid; blk < T4 * T4; blk += AT_THREADS) {
      const int i0 = (blk / T4) * 4, j0 = (blk % T4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, qT, AT_T, i0, kT, AT_T, j0, E);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          AT[(j0 + jj) * AT_T + i0 + ii] = j0 + jj <= i0 + ii ? a[ii][jj] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < AT_T; i += AT_THREADS) {
      float s = 0.f;
      for (int j = 0; j < AT_T; ++j) s += AT[j * AT_T + i];
      for (int e = 0; e < E; ++e) s = fmaf(qT[e * AT_T + i], z[e], s);
      dn[i] = s;
    }
    __syncthreads();
    for (int blk = tid; blk < T4 * E4; blk += AT_THREADS) {
      const int i0 = (blk / E4) * 4, f0 = (blk % E4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, AT, AT_T, i0, v, E, f0, AT_T);
      outer4(a, qT, AT_T, i0, Sm, E, f0, E);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i >= nv) continue;
        T* out = att + ((size_t)b * S + t0 + i) * D + h * E + f0;
        const float dd = dn[i] + eps;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) st(out + jj, a[ii][jj] / dd);
      }
    }
    for (int i = tid; i < nv; i += AT_THREADS) den[((size_t)b * S + t0 + i) * H + h] = dn[i];
    __syncthreads();
    for (int blk = tid; blk < E4 * E4; blk += AT_THREADS) {
      const int e0 = (blk / E4) * 4, f0 = (blk % E4) * 4;
      float a[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) a[ii][jj] = Sm[(e0 + ii) * E + f0 + jj];
      outer4(a, k, E, e0, v, E, f0, AT_T);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) Sm[(e0 + ii) * E + f0 + jj] = a[ii][jj];
    }
    for (int e = tid; e < E; e += AT_THREADS) {
      float s = 0.f;
      for (int j = 0; j < AT_T; ++j) s += k[j * E + e];
      z[e] += s;
    }
    __syncthreads();
  }
}

// dnum (transposed into dnT[f][i], and row-major into dnr when given) and
// dd of one tile, one warp per row; rows past the sequence are zeros.
template <typename T>
__device__ __forceinline__ void load_dnum(const T* g, const T* att, const float* den, float* dnT,
                                          float* dnr, float* dd, int b, int h, int t0, int nv,
                                          int S, int D, int H, int E, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < AT_T; i += AT_THREADS / 32) {
    float s = 0.f;
    if (i < nv) {
      const size_t row = (size_t)b * S + t0 + i;
      const float dv = den[row * H + h] + eps;
      for (int f = lane; f < E; f += 32) {
        const float gv = ld(g + row * D + h * E + f);
        s = fmaf(gv, ld(att + row * D + h * E + f), s);
        const float dnv = gv / dv;
        dnT[f * AT_T + i] = dnv;
        if (dnr != nullptr) dnr[i * E + f] = dnv;
      }
      s = -warp_sum(s) / dv;
    } else {
      for (int f = lane; f < E; f += 32) {
        dnT[f * AT_T + i] = 0.f;
        if (dnr != nullptr) dnr[i * E + f] = 0.f;
      }
    }
    if (lane == 0) dd[i] = s;
  }
}

// Forward-order pass: dqkv[:, h E + e] = d phi(q) * min(phi(q), 1).
template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dq_kernel(const T* __restrict__ pqkv, const T* __restrict__ g, const T* __restrict__ att,
                   const float* __restrict__ den, T* __restrict__ dqkv, int S, int D, int H,
                   int E, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* dnT = sm;                   // E x T
  float* vT = dnT + E * AT_T;        // E x T
  float* v = vT + E * AT_T;          // T x E
  float* k = v + AT_T * E;           // T x E
  float* MT = k + AT_T * E;          // T x T, MT[j][i]
  float* ST = MT + AT_T * AT_T;      // E x E, ST[f][e] = S[e][f]
  float* z = ST + E * E;             // E
  float* dd = z + E;                 // T
  for (int i = tid; i < E * E; i += AT_THREADS) ST[i] = 0.f;
  for (int i = tid; i < E; i += AT_THREADS) z[i] = 0.f;
  const int E4 = E / 4, T4 = AT_T / 4;
  const size_t D3 = 3 * (size_t)D;
  for (int t0 = 0; t0 < S; t0 += AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float kv = 0.f, vv = 0.f;
      if (i < nv) {
        const T* row = pqkv + ((size_t)b * S + t0 + i) * D3 + h * E + e;
        kv = ld(row + D);
        vv = ld(row + 2 * D);
      }
      k[i * E + e] = kv;
      v[i * E + e] = vv;
      vT[e * AT_T + i] = vv;
    }
    load_dnum(g, att, den, dnT, (float*)nullptr, dd, b, h, t0, nv, S, D, H, E, eps);
    __syncthreads();
    // M[i][j] = dnum_i . v_j + dd_i for j <= i
    for (int blk = tid; blk < T4 * T4; blk += AT_THREADS) {
      const int i0 = (blk / T4) * 4, j0 = (blk % T4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, dnT, AT_T, i0, vT, AT_T, j0, E);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          MT[(j0 + jj) * AT_T + i0 + ii] = j0 + jj <= i0 + ii ? a[ii][jj] + dd[i0 + ii] : 0.f;
    }
    __syncthreads();
    // dq = M k + dnum S^T + dd z
    for (int blk = tid; blk < T4 * E4; blk += AT_THREADS) {
      const int i0 = (blk / E4) * 4, e0 = (blk % E4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, MT, AT_T, i0, k, E, e0, AT_T);
      outer4(a, dnT, AT_T, i0, ST, E, e0, E);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i >= nv) continue;
        const size_t row = (size_t)b * S + t0 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int e = e0 + jj;
          const float dq = fmaf(dd[i], z[e], a[ii][jj]);
          const float pq = ld(pqkv + row * D3 + h * E + e);
          st(dqkv + row * D3 + h * E + e, dq * fminf(pq, 1.f));
        }
      }
    }
    __syncthreads();
    for (int blk = tid; blk < E4 * E4; blk += AT_THREADS) {
      const int f0 = (blk / E4) * 4, e0 = (blk % E4) * 4;
      float a[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) a[ii][jj] = ST[(f0 + ii) * E + e0 + jj];
      outer4(a, v, E, f0, k, E, e0, AT_T);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) ST[(f0 + ii) * E + e0 + jj] = a[ii][jj];
    }
    for (int e = tid; e < E; e += AT_THREADS) {
      float s = 0.f;
      for (int j = 0; j < AT_T; ++j) s += k[j * E + e];
      z[e] += s;
    }
    __syncthreads();
  }
}

// Reverse-order pass: dqkv[:, D + h E + e] = d phi(k) * min(phi(k), 1) and
// dqkv[:, 2D + h E + f] = dv.
template <typename T>
__global__ void __launch_bounds__(AT_THREADS)
attn_bwd_dkv_kernel(const T* __restrict__ pqkv, const T* __restrict__ g,
                    const T* __restrict__ att, const float* __restrict__ den,
                    T* __restrict__ dqkv, int S, int D, int H, int E, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* q = sm;                     // T x E
  float* qT = q + AT_T * E;          // E x T
  float* kT = qT + E * AT_T;         // E x T
  float* vT = kT + E * AT_T;         // E x T
  float* dn = vT + E * AT_T;         // T x E
  float* dnT = dn + AT_T * E;        // E x T
  float* PT = dnT + E * AT_T;        // T x T, PT[i][j]
  float* G = PT + AT_T * AT_T;       // E x E
  float* GT = G + E * E;             // E x E, GT[f][e] = G[e][f]
  float* gz = GT + E * E;            // E
  float* dd = gz + E;                // T
  for (int i = tid; i < E * E; i += AT_THREADS) G[i] = GT[i] = 0.f;
  for (int i = tid; i < E; i += AT_THREADS) gz[i] = 0.f;
  const int E4 = E / 4, T4 = AT_T / 4;
  const size_t D3 = 3 * (size_t)D;
  for (int t0 = ((S - 1) / AT_T) * AT_T; t0 >= 0; t0 -= AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float qv = 0.f, kv = 0.f, vv = 0.f;
      if (i < nv) {
        const T* row = pqkv + ((size_t)b * S + t0 + i) * D3 + h * E + e;
        qv = ld(row);
        kv = ld(row + D);
        vv = ld(row + 2 * D);
      }
      q[i * E + e] = qv;
      qT[e * AT_T + i] = qv;
      kT[e * AT_T + i] = kv;
      vT[e * AT_T + i] = vv;
    }
    load_dnum(g, att, den, dnT, dn, dd, b, h, t0, nv, S, D, H, E, eps);
    __syncthreads();
    // Nm[j][i] = v_j . dnum_i + dd_i for i >= j, stored PT[i][j]
    for (int blk = tid; blk < T4 * T4; blk += AT_THREADS) {
      const int j0 = (blk / T4) * 4, i0 = (blk % T4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, vT, AT_T, j0, dnT, AT_T, i0, E);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          PT[(i0 + ii) * AT_T + j0 + jj] = i0 + ii >= j0 + jj ? a[jj][ii] + dd[i0 + ii] : 0.f;
    }
    __syncthreads();
    // dk = Nm q + v G^T + gz
    for (int blk = tid; blk < T4 * E4; blk += AT_THREADS) {
      const int j0 = (blk / E4) * 4, e0 = (blk % E4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, PT, AT_T, j0, q, E, e0, AT_T);
      outer4(a, vT, AT_T, j0, GT, E, e0, E);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j >= nv) continue;
        const size_t row = (size_t)b * S + t0 + j;
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          const int e = e0 + ee;
          const float pk = ld(pqkv + row * D3 + D + h * E + e);
          st(dqkv + row * D3 + D + h * E + e, (a[jj][ee] + gz[e]) * fminf(pk, 1.f));
        }
      }
    }
    __syncthreads();
    // P[j][i] = k_j . q_i for i >= j, stored PT[i][j]
    for (int blk = tid; blk < T4 * T4; blk += AT_THREADS) {
      const int j0 = (blk / T4) * 4, i0 = (blk % T4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, kT, AT_T, j0, qT, AT_T, i0, E);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          PT[(i0 + ii) * AT_T + j0 + jj] = i0 + ii >= j0 + jj ? a[jj][ii] : 0.f;
    }
    __syncthreads();
    // dv = P dnum + k G
    for (int blk = tid; blk < T4 * E4; blk += AT_THREADS) {
      const int j0 = (blk / E4) * 4, f0 = (blk % E4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, PT, AT_T, j0, dn, E, f0, AT_T);
      outer4(a, kT, AT_T, j0, G, E, f0, E);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j >= nv) continue;
        T* out = dqkv + ((size_t)b * S + t0 + j) * D3 + 2 * D + h * E + f0;
#pragma unroll
        for (int ff = 0; ff < 4; ++ff) st(out + ff, a[jj][ff]);
      }
    }
    __syncthreads();
    // G += q^T dnum, gz += dd^T q
    for (int blk = tid; blk < E4 * E4; blk += AT_THREADS) {
      const int e0 = (blk / E4) * 4, f0 = (blk % E4) * 4;
      float a[4][4];
      zero4(a);
      outer4(a, q, E, e0, dn, E, f0, AT_T);
#pragma unroll
      for (int ee = 0; ee < 4; ++ee)
#pragma unroll
        for (int ff = 0; ff < 4; ++ff) {
          G[(e0 + ee) * E + f0 + ff] += a[ee][ff];
          GT[(f0 + ff) * E + e0 + ee] += a[ee][ff];
        }
    }
    for (int e = tid; e < E; e += AT_THREADS) {
      float s = 0.f;
      for (int i = 0; i < AT_T; ++i) s = fmaf(dd[i], q[i * E + e], s);
      gz[e] += s;
    }
    __syncthreads();
  }
}

template <typename T>
int qkv_attn_fwd(const T* h, const T* w, const T* bias, T* pqkv, T* att, float* den, int N,
                 int n_seq, int D, int H, float eps, cudaStream_t st) {
  const int E = D / H, S = N / n_seq;
  Epi<T, T> e;
  e.out = pqkv;
  e.bias = bias;
  e.act = ACT_PHI;
  e.phi_cols = 2 * D;
  int rc = gemm<false, false>(h, w, N, 3 * D, D, e, st);
  if (rc) return rc;
  const size_t smem = fwd_smem_floats(E) * sizeof(float);
  cudaFuncSetAttribute(attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  attn_fwd_kernel<T><<<dim3(H, n_seq), AT_THREADS, smem, st>>>(pqkv, att, den, S, D, H, E, eps);
  RLMG_CHECK();
  return 0;
}

template <typename T>
int qkv_attn_bwd(const T* pqkv, const T* g, const T* att, const float* den, T* dqkv, int N,
                 int n_seq, int D, int H, float eps, cudaStream_t st) {
  const int E = D / H, S = N / n_seq;
  const size_t s1 = dq_smem_floats(E) * sizeof(float), s2 = dkv_smem_floats(E) * sizeof(float);
  cudaFuncSetAttribute(attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s1);
  cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  attn_bwd_dq_kernel<T><<<dim3(H, n_seq), AT_THREADS, s1, st>>>(pqkv, g, att, den, dqkv, S, D, H,
                                                                  E, eps);
  RLMG_CHECK();
  attn_bwd_dkv_kernel<T><<<dim3(H, n_seq), AT_THREADS, s2, st>>>(pqkv, g, att, den, dqkv, S, D,
                                                                   H, E, eps);
  RLMG_CHECK();
  return 0;
}

inline bool attn_shape_ok(int N, int n_seq, int D, int H) {
  if (H <= 0 || n_seq <= 0 || D % H || N % n_seq) return false;
  const int E = D / H;
  return E % 4 == 0 && E <= AT_MAX_E;
}

}  // namespace rlmg

extern "C" {

// h (N, D), w (D, 3D), b (3D) in one type (bf16 = 1: bfloat16, else f32).
// Writes pqkv (N, 3D) and att (N, D) in that type and den (N, H) f32.
// N = n_seq sequences of N / n_seq rows.  Returns 0 or a CUDA error code.
int rlmg_qkv_attn_fwd(const void* h, const void* w, const void* b, void* pqkv, void* att,
                      float* den, int N, int n_seq, int D, int H, float eps, int bf16,
                      void* stream) {
  using namespace rlmg;
  using bf = __nv_bfloat16;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_fwd<bf>((const bf*)h, (const bf*)w, (const bf*)b, (bf*)pqkv, (bf*)att, den, N,
                            n_seq, D, H, eps, st);
  return qkv_attn_fwd<float>((const float*)h, (const float*)w, (const float*)b, (float*)pqkv,
                             (float*)att, den, N, n_seq, D, H, eps, st);
}

// From the forward's pqkv, att, den and the upstream gradient g (N, D),
// writes dqkv (N, 3D) = [d phi(q) * phi'(q) | d phi(k) * phi'(k) | dv].
int rlmg_qkv_attn_bwd(const void* pqkv, const void* g, const void* att, const float* den,
                      void* dqkv, int N, int n_seq, int D, int H, float eps, int bf16,
                      void* stream) {
  using namespace rlmg;
  using bf = __nv_bfloat16;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_bwd<bf>((const bf*)pqkv, (const bf*)g, (const bf*)att, den, (bf*)dqkv, N,
                            n_seq, D, H, eps, st);
  return qkv_attn_bwd<float>((const float*)pqkv, (const float*)g, (const float*)att, den,
                             (float*)dqkv, N, n_seq, D, H, eps, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
