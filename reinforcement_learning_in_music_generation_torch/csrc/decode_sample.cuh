// The embedding and the heads + sampling pass of a decode token, as device
// functions for one block: shared by decode_chunk.cu (kernel B) and
// latency_decode.cu (the latency kernels), so every chunked path folds the
// embedding and draws its tokens the same way.
//
//   embed_row        h[b] = sum_f M[off_f + tok_f] + b_in + pe[pos]: the
//                    embedding folded through in_linear (one row per
//                    (field, id))
//   heads_sample_row one (song, field) by a block of VF_PAD threads: final
//                    LN, the padded head product (VF_PAD columns per field,
//                    NEG bias in the padding), temperature, the 24-step
//                    bisection nucleus threshold, Gumbel-max with bits from
//                    Philox4x32-10 at counter (position, field, vocab index,
//                    song), first-argmax; its sampling half, sample_logit,
//                    also serves kernel B's tensor-core route
//                    (decode_chunk_tc.cuh), whose head product is a GEMM
//
// Both read what an earlier phase of the same launch may have written (the
// tokens, h) with __ldcg, past the SM's L1, so a persistent kernel sees the
// values other blocks stored before its grid barrier.

#pragma once

#include "decode_layers.cuh"

namespace rlmg {

constexpr int VF_PAD = 256, MAX_NF = 8, NUCLEUS_ITERS = 24;
constexpr float NEG = -1e30f;

struct FieldArgs {
  int off[MAX_NF];      // first row of field f in the folded embedding M
  float tinv[MAX_NF];   // 1 / temperature
  float topp[MAX_NF];   // nucleus mass (inf: keep every token)
};

inline FieldArgs field_args(const int* off, const float* tinv, const float* topp, int NF) {
  FieldArgs fa{};
  for (int f = 0; f < NF; ++f) {
    fa.off[f] = off ? off[f] : 0;
    fa.tinv[f] = tinv[f];
    fa.topp[f] = topp[f];
  }
  return fa;
}

// Standard Gumbel noise from 32 random bits: u in (0,1) from the top 24.
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.9802322387695312e-08f;
  return -logf(-logf(u));
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// Index of the first maximal value over the block (ties: smallest index).
__device__ __forceinline__ int block_argmax_first(float v, int i, float* rv, int* ri) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    rv[wid] = v;
    ri[wid] = i;
  }
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? rv[lane] : -INFINITY;
    i = lane < nw ? ri[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) ri[0] = i;
  }
  __syncthreads();
  i = ri[0];
  __syncthreads();
  return i;
}

// h_b (D) = sum_f m[off_f + tok_b[f]] + bin + pe_row, summed in field order.
__device__ __forceinline__ void embed_row(const int* tok_b, const float* __restrict__ m,
                                          const FieldArgs& fa, const float* __restrict__ bin,
                                          const float* __restrict__ pe_row, float* h_b, int NF,
                                          int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int f = 0; f < NF; ++f) acc += m[(size_t)(fa.off[f] + __ldcg(tok_b + f)) * D + d];
    h_b[d] = (acc + bin[d]) + pe_row[d];
  }
}

// The token of field f for song b from its tempered logit x (thread v of a
// block of VF_PAD owns vocab index v), returned to every thread: greedy
// first-argmax, or the 24-step bisection nucleus threshold and Gumbel-max
// with bits from Philox4x32-10 at counter (position, field, vocab index,
// song).  red, redi: 32 values each of shared memory.
__device__ __forceinline__ int sample_logit(float x, const FieldArgs& fa, int b, int f, int pos,
                                            uint32_t seed, int greedy, float* red, int* redi) {
  const int v = threadIdx.x;
  if (greedy) return block_argmax_first(x, v, red, redi);
  const float mx = block_max(x, red);
  const float ex = expf(x - mx);
  const float p = ex / (block_sum(ex, red) * 1.00001f);
  const float tp = fa.topp[f];
  float lo = 0.f, hi = 1.f;
  for (int it = 0; it < NUCLEUS_ITERS; ++it) {
    const float mid = 0.5f * (lo + hi);
    const float mass = block_sum(p > mid ? p : 0.f, red);
    if (mass > tp) lo = mid;
    else hi = mid;
  }
  const uint32_t bits = philox_first(seed, (uint32_t)pos, (uint32_t)f, (uint32_t)v, (uint32_t)b);
  const float score = p > lo ? x + gumbel_from_bits(bits) : NEG;
  return block_argmax_first(score, v, red, redi);
}

// The token of field f for song b from h_b (D, before the final LN), by a
// block of VF_PAD threads (thread v owns logit v); returned to every
// thread.  hf: D floats of shared memory; red, redi: 32 each.
template <typename TW>
__device__ __forceinline__ int heads_sample_row(const float* h_b, const float* __restrict__ fls,
                                                const float* __restrict__ flb,
                                                const TW* __restrict__ hw,
                                                const float* __restrict__ hb,
                                                const FieldArgs& fa, int b, int f, int NF,
                                                int D, int pos, uint32_t seed, int greedy,
                                                float* hf, float* red, int* redi) {
  const int v = threadIdx.x;
  for (int i = v; i < D; i += blockDim.x) hf[i] = __ldcg(h_b + i);
  __syncthreads();
  ln_row(hf, D, 1e-5f, red);
  for (int i = v; i < D; i += blockDim.x) hf[i] = hf[i] * fls[i] + flb[i];
  __syncthreads();
  const int ncol = NF * VF_PAD, col = f * VF_PAD + v;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(hf[d], ld(hw + (size_t)d * ncol + col), acc);
  const float x = (acc + hb[col]) * fa.tinv[f];
  return sample_logit(x, fa, b, f, pos, seed, greedy, red, redi);
}

}  // namespace rlmg
