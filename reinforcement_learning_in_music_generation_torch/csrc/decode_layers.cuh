// SIMT building blocks of the decode kernels: the state update of one
// (song, head) slice (attn_slice: the latency kernels), block sums and LN
// rows, phi, the gelus, Philox and the layer-weight order (every decode
// route).  (Kernel A, v3, v2 and v1 run decode_stack_tc.cuh, kernel B
// decode_chunk_tc.cuh.)  Plain C interface; no PyTorch headers.
//
// Everything accumulates in f32; weights are read in their stored type
// (float or bf16), the state (S, z) in its own (float or bf16).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlmg {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// x rounded to TW's precision (a product input cast to the weights' type)
template <typename TW>
__device__ __forceinline__ float ld_round(float x) {
  return sizeof(TW) == 2 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(fminf(x, 0.f)); }
__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}
// jax.nn.gelu(x, approximate=True), the gelu of the per-layer v1 / v2 decode
// kernels (decode_stack_tc.cuh's TANH)
__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

// First output word of Philox4x32-10 at counter (c0..c3), key (seed,
// PHILOX_KEY1).  ops/decode_common.py philox_bits draws the same bits.
constexpr uint32_t PHILOX_KEY1 = 0x5DEECE66u;

__device__ __forceinline__ uint32_t philox_first(uint32_t seed, uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3) {
  uint32_t k0 = seed, k1 = PHILOX_KEY1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

// the epilogue activations of train_gemm_tc.cuh's products
enum { ACT_NONE = 0, ACT_GELU = 1 };

constexpr int ATT_THREADS = 256, MAX_E = 128;

// The state update and read of one (song, head) slice by one block of
// ATT_THREADS threads: S += k v^T, z += k, att = q^T S / (q.z + eps), with
// phi(q), phi(k) and v (E values each) in shared memory.  sp (E,E), rows
// `rs` values apart (E in the DecodeState layout, H E in the batch-major
// layout of the v5 kernel), and zp (E) are updated in place, in their
// stored type, wherever they live (device memory for the per-step and
// chunked kernels, shared memory for the latency kernel's resident state);
// the read uses the f32 sums before they are rounded.  att (E) may be
// device or shared memory.  part (ATT_THREADS), dq (E) and den_s (1) are
// shared scratch.  Ends before att is written for every thread: the
// caller synchronises.
template <typename TS>
__device__ __forceinline__ void attn_slice(const float* qs, const float* ks, const float* vs,
                                           TS* sp, TS* zp, float* att, int E, float eps,
                                           float* part, float* dq, float* den_s, int rs) {
  const int tid = threadIdx.x;
  // thread (jg, u): column u of S, rows jg, jg+G, ... (G = 256/E groups)
  const int G = ATT_THREADS / E, u = tid % E, jg = tid / E;
  float num = 0.f;
  for (int j = jg; j < E; j += G) {
    TS* p = sp + (size_t)j * rs + u;
    const float sv = fmaf(ks[j], vs[u], ld(p));
    st(p, sv);
    num = fmaf(qs[j], sv, num);
  }
  part[tid] = num;
  if (tid < E) {
    TS* p = zp + tid;
    const float zv = ld(p) + ks[tid];
    st(p, zv);
    dq[tid] = qs[tid] * zv;
  }
  __syncthreads();
  if (tid < 32) {
    float d = 0.f;
    for (int i = tid; i < E; i += 32) d += dq[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (tid == 0) *den_s = d + eps;
  }
  __syncthreads();
  if (tid < E) {
    float n = 0.f;
    for (int g = 0; g < G; ++g) n += part[g * E + tid];
    att[tid] = n / *den_s;
  }
}

// Sum over the block, returned to every thread.  red: 32 floats of shared.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

constexpr int LN_THREADS = 256, MAX_D = 2048;

// Row-wise layernorm of x (D values in shared memory, f32), in place.
__device__ __forceinline__ void ln_row(float* xr, int D, float eps, float* red) {
  float sum = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) sum += xr[i];
  const float mu = block_sum(sum, red) / D;
  float sq = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = xr[i] - mu;
    sq += d * d;
  }
  const float inv = rsqrtf(block_sum(sq, red) / D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) xr[i] = (xr[i] - mu) * inv;
  __syncthreads();
}

#define RLMG_CHECK()                           \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// Layer weights, per-layer slices of (L, ...) stacks, all in one type TW:
// qkv_w (D,3D), qkv_b (3D), wo_w (D,D), wo_b, ln1_s, ln1_b (D),
// f1_w (D,DI), f1_b (DI), f2_w (DI,D), f2_b, ln2_s, ln2_b (D).
enum { W_QKV, B_QKV, W_O, B_O, LN1_S, LN1_B, W_F1, B_F1, W_F2, B_F2, LN2_S, LN2_B, N_WEIGHTS };

inline bool stack_shape_ok(int D, int H) {
  const int E = H > 0 ? D / H : 0;
  return E * H == D && E <= MAX_E && ATT_THREADS % E == 0 && D <= MAX_D;
}

}  // namespace rlmg
