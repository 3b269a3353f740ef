// The chunked causal linear-attention passes, forward and backward, of
// kernel C (attention_block.cu: q, k, v packed in the qkv projection's
// (N, 3D) output, phi' folded into the gradient); kernel F
// (causal_product.cu) has passes of its own.  The kernels are templates over an I/O
// policy IO that says where row i of head h of sequence b lives:
//   float q/k/v(b, h, i, e)        inputs (phi(q), phi(k), v)
//   float g/out(b, h, i, f)        upstream gradient and forward output
//   float den(b, h, i)             forward denominator (unclipped)
//   put_out / put_den / put_dq / put_dk / put_dv(b, h, i, [e,] x)
//
// One block per (head, sequence) walks the sequence in tiles of AT_T = 64
// rows with the running state S = sum phi(k) v^T (E x E) and z = sum phi(k)
// in shared memory, in place of the TPU's sequential grid axis:
//   A = tril(q k^T),  num = A v + q S,  den = rowsum(A) + q.z,
//   out = num / (den + eps),  then S += k^T v, z += colsum(k).
// Backward, two passes over the same blocks, no atomics (bit-reproducible):
//   la_bwd_dq_kernel   tiles in order with prefix (S, z):  d phi(q)
//   la_bwd_dkv_kernel  tiles in reverse with suffix (G, gz): d phi(k), dv
// with dnum = g / (den + eps) and dd = -sum(g * out) / (den + eps) formed
// in the passes' prologue (load_dnum).  Rows at or past S load as zeros, so
// a ragged last tile adds nothing to the state or to the gradients and is
// never written: no padded copy.  The tile length is a numerics-free choice
// (any tiling of the causal sum gives the same result up to rounding).
// Every product is a 4x4 register-blocked outer product from shared memory
// (outer4, train_gemm.cuh); the (T, T) score tiles and the states never
// leave shared memory.  No tensor cores yet.

#pragma once

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

// Block (head h = blockIdx.x, sequence b = blockIdx.y); S rows, head width E.
template <class IO>
__global__ void __launch_bounds__(AT_THREADS)
la_fwd_kernel(IO io, int S, int E, float eps) {
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
  for (int t0 = 0; t0 < S; t0 += AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float qv = 0.f, kv = 0.f, vv = 0.f;
      if (i < nv) {
        qv = io.q(b, h, t0 + i, e);
        kv = io.k(b, h, t0 + i, e);
        vv = io.v(b, h, t0 + i, e);
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
        const float dd = dn[i] + eps;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) io.put_out(b, h, t0 + i, f0 + jj, a[ii][jj] / dd);
      }
    }
    for (int i = tid; i < nv; i += AT_THREADS) io.put_den(b, h, t0 + i, dn[i]);
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

// dnum of one tile (transposed into dnT[f][i], and row-major into dnr when
// given) and dd, one warp per row; rows past the sequence are zeros.
template <class IO>
__device__ __forceinline__ void load_dnum(const IO& io, float* dnT, float* dnr, float* dd, int b,
                                          int h, int t0, int nv, int E, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < AT_T; i += AT_THREADS / 32) {
    float s = 0.f;
    if (i < nv) {
      const float dv = io.den(b, h, t0 + i) + eps;
      for (int f = lane; f < E; f += 32) {
        const float gv = io.g(b, h, t0 + i, f);
        s = fmaf(gv, io.out(b, h, t0 + i, f), s);
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

// Forward-order pass: d phi(q) = M k + dnum S^T + dd z, M = tril(dnum v^T + dd).
template <class IO>
__global__ void __launch_bounds__(AT_THREADS)
la_bwd_dq_kernel(IO io, int S, int E, float eps) {
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
  for (int t0 = 0; t0 < S; t0 += AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float kv = 0.f, vv = 0.f;
      if (i < nv) {
        kv = io.k(b, h, t0 + i, e);
        vv = io.v(b, h, t0 + i, e);
      }
      k[i * E + e] = kv;
      v[i * E + e] = vv;
      vT[e * AT_T + i] = vv;
    }
    load_dnum(io, dnT, (float*)nullptr, dd, b, h, t0, nv, E, eps);
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
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int e = e0 + jj;
          io.put_dq(b, h, t0 + i, e, fmaf(dd[i], z[e], a[ii][jj]));
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

// Reverse-order pass: d phi(k) = Nm q + v G^T + gz with Nm = triu(v dnum^T
// + dd), and dv = P dnum + k G with P = triu(k q^T).
template <class IO>
__global__ void __launch_bounds__(AT_THREADS)
la_bwd_dkv_kernel(IO io, int S, int E, float eps) {
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
  for (int t0 = ((S - 1) / AT_T) * AT_T; t0 >= 0; t0 -= AT_T) {
    const int nv = min(AT_T, S - t0);
    for (int idx = tid; idx < AT_T * E; idx += AT_THREADS) {
      const int i = idx / E, e = idx % E;
      float qv = 0.f, kv = 0.f, vv = 0.f;
      if (i < nv) {
        qv = io.q(b, h, t0 + i, e);
        kv = io.k(b, h, t0 + i, e);
        vv = io.v(b, h, t0 + i, e);
      }
      q[i * E + e] = qv;
      qT[e * AT_T + i] = qv;
      kT[e * AT_T + i] = kv;
      vT[e * AT_T + i] = vv;
    }
    load_dnum(io, dnT, dn, dd, b, h, t0, nv, E, eps);
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
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          const int e = e0 + ee;
          io.put_dk(b, h, t0 + j, e, a[jj][ee] + gz[e]);
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
#pragma unroll
        for (int ff = 0; ff < 4; ++ff) io.put_dv(b, h, t0 + j, f0 + ff, a[jj][ff]);
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

// Launches on n_seq sequences of H heads, S rows, head width E.
template <class IO>
int la_forward(const IO& io, int n_seq, int H, int S, int E, float eps, cudaStream_t st) {
  const size_t smem = fwd_smem_floats(E) * sizeof(float);
  cudaFuncSetAttribute(la_fwd_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  la_fwd_kernel<IO><<<dim3(H, n_seq), AT_THREADS, smem, st>>>(io, S, E, eps);
  RLMG_CHECK();
  return 0;
}

template <class IO>
int la_backward(const IO& io, int n_seq, int H, int S, int E, float eps, cudaStream_t st) {
  const size_t s1 = dq_smem_floats(E) * sizeof(float), s2 = dkv_smem_floats(E) * sizeof(float);
  cudaFuncSetAttribute(la_bwd_dq_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  cudaFuncSetAttribute(la_bwd_dkv_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s2);
  la_bwd_dq_kernel<IO><<<dim3(H, n_seq), AT_THREADS, s1, st>>>(io, S, E, eps);
  RLMG_CHECK();
  la_bwd_dkv_kernel<IO><<<dim3(H, n_seq), AT_THREADS, s2, st>>>(io, S, E, eps);
  RLMG_CHECK();
  return 0;
}

}  // namespace rlmg
