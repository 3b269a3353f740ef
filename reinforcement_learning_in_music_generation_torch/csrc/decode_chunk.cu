// T decode tokens per call, with the sampling on the card: the CUDA
// counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/decode_kernel_v6.py
// fused_decode_v6 (its Pallas body _v6_kernel).
//
// The computation is ported, not the TPU layout: v6 carried the network
// transposed (batch on the 128 lanes) to dodge lane<->sublane relayouts on
// the TPU's vector unit; here every tensor is batch-major and the state
// keeps the DecodeState layout S (L,B,H,E,E), z (L,B,H,E).
//
// Per token, rlmg_decode_chunk launches, on one stream:
//   embed_kernel        h = sum_f M[off_f + tok_f] + b_in + pe[pos]: the
//                       embedding folded through in_linear (one row per
//                       (field, id)), one block per song
//   layer stack         decode_layers.cuh, the kernels of decode_step.cu
//   heads_sample_kernel one block per (song, field): final LN, the padded
//                       head product (VF_PAD columns per field, NEG bias in
//                       the padding), temperature, the 24-step bisection
//                       nucleus threshold, Gumbel-max with bits from
//                       Philox4x32-10, first-argmax
// (the bodies of both, embed_row and heads_sample_row, are in
// decode_sample.cuh, shared with latency_decode.cu) and feeds each emitted
// token to the next step.  The host loop over T
// stays in C, so a chunk costs one call from Python; v6's single launch
// per chunk (the whole loop inside one kernel) is not reproduced yet.
//
// Random bits: Philox4x32-10 keyed by (seed, PHILOX_KEY1) at counter
// (absolute position, field, vocab index, song).  The stream depends only
// on the position, so one call of 64 tokens and two of 32 emit the same
// tokens.  ops/decode_common.py philox_bits draws the same bits in torch.
//
// Bound on the card.  Per call the weights are read once (151 MB in f32 at
// the flagship width) and the state once in and once out (201 MB in bf16 at
// B=128); per token the products take 2*B*(L*(4*D*D + 2*D*DI) +
// D*NF*VF_PAD) operations (9.7 GFLOP at B=128).  At B=128 and T=128 the
// operations bind (67 TFLOP/s for f32 FMAs outside the tensor cores, 989
// TFLOP/s bf16 in them).  This design keeps the per-token intermediates in
// one f32 scratch buffer and the sampling in one pass over each field's
// 256 logits, held in registers; the products are the K-split tiled GEMMs
// of decode_layers.cuh, without tensor cores yet.

#include "decode_sample.cuh"

namespace rlmg {

// h[b] = embed_row(tok[b]), one block per song.
__global__ void embed_kernel(const int* __restrict__ tok, const float* __restrict__ m,
                             FieldArgs fa, const float* __restrict__ bin,
                             const float* __restrict__ pe_row, float* __restrict__ h, int NF,
                             int D) {
  const int b = blockIdx.x;
  embed_row(tok + (size_t)b * NF, m, fa, bin, pe_row, h + (size_t)b * D, NF, D);
}

// One block of VF_PAD threads per (song b, field f).
template <typename TW>
__global__ void __launch_bounds__(VF_PAD)
heads_sample_kernel(const float* __restrict__ h, const float* __restrict__ fls,
                    const float* __restrict__ flb, const TW* __restrict__ hw,
                    const float* __restrict__ hb, FieldArgs fa, int* __restrict__ tok_out,
                    int NF, int D, int pos, uint32_t seed, int greedy) {
  __shared__ float hf[MAX_D];
  __shared__ float red[32];
  __shared__ int redi[32];
  const int b = blockIdx.x / NF, f = blockIdx.x % NF;
  const int tok = heads_sample_row<TW>(h + (size_t)b * D, fls, flb, hw, hb, fa, b, f, NF, D,
                                       pos, seed, greedy, hf, red, redi);
  if (threadIdx.x == 0) tok_out[(size_t)b * NF + f] = tok;
}

inline int heads_sample(const float* h, const float* fls, const float* flb, const void* hw,
                        const float* hb, const FieldArgs& fa, int* tok_out, int B, int NF,
                        int D, int pos, uint32_t seed, int greedy, int w_bf16,
                        cudaStream_t st) {
  if (w_bf16) {
    heads_sample_kernel<__nv_bfloat16><<<B * NF, VF_PAD, 0, st>>>(
        h, fls, flb, (const __nv_bfloat16*)hw, hb, fa, tok_out, NF, D, pos, seed, greedy);
  } else {
    heads_sample_kernel<float><<<B * NF, VF_PAD, 0, st>>>(h, fls, flb, (const float*)hw, hb,
                                                          fa, tok_out, NF, D, pos, seed, greedy);
  }
  RLMG_CHECK();
  return 0;
}

}  // namespace rlmg

extern "C" {

long long rlmg_stack_scratch_floats(int B, int D, int DI) {
  return (long long)rlmg::stack_scratch_floats(B, D, DI);
}

// Decode T tokens.  tok0 (B,NF) int32 is fed at position t0; tokens (T,B,NF)
// int32 receives the T successors (tokens[t] is fed at t0+t+1 by the next
// step or call).  s, z are updated in place.  off, tinv, topp are host
// arrays of NF values.  h (B,D) f32 and scratch
// (rlmg_stack_scratch_floats) are the caller's.  pe is the whole (max_len, D)
// f32 table; rows t0..t0+T-1 are read.
int rlmg_decode_chunk(const int* tok0, int* tokens, const float* m, const float* bin,
                      const float* pe, const void* const* w, const void* hw, const float* hb,
                      const float* fls, const float* flb, const int* off, const float* tinv,
                      const float* topp, void* s, void* z, float* h, float* scratch, int T,
                      int t0, unsigned int seed, int greedy, int L, int B, int D, int H,
                      int DI, int NF, float eps, int w_bf16, int s_bf16, void* stream) {
  if (!rlmg::stack_shape_ok(D, H) || NF > rlmg::MAX_NF || NF < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const rlmg::FieldArgs fa = rlmg::field_args(off, tinv, topp, NF);
  const size_t bnf = (size_t)B * NF;
  for (int t = 0; t < T; ++t) {
    const int* tin = t == 0 ? tok0 : tokens + (t - 1) * bnf;
    rlmg::embed_kernel<<<B, 256, 0, st>>>(tin, m, fa, bin, pe + (size_t)(t0 + t) * D, h, NF,
                                          D);
    RLMG_CHECK();
    int rc = rlmg::stack_step_any(h, w, s, z, scratch, L, B, D, H, DI, eps, w_bf16, s_bf16, st);
    if (rc) return rc;
    rc = rlmg::heads_sample(h, fls, flb, hw, hb, fa, tokens + t * bnf, B, NF, D, t0 + t, seed,
                            greedy, w_bf16, st);
    if (rc) return rc;
  }
  return 0;
}

// The heads + sampling pass alone, on a given final hidden state h (B,D)
// (before the final LN), as the chunk runs it for position pos.
int rlmg_heads_sample(const float* h, const void* hw, const float* hb, const float* fls,
                      const float* flb, const float* tinv, const float* topp, int* tok_out,
                      int B, int D, int NF, int pos, unsigned int seed, int greedy, int w_bf16,
                      void* stream) {
  if (NF > rlmg::MAX_NF || NF < 1 || D > rlmg::MAX_D) return (int)cudaErrorInvalidValue;
  const rlmg::FieldArgs fa = rlmg::field_args(nullptr, tinv, topp, NF);
  return rlmg::heads_sample(h, fls, flb, hw, hb, fa, tok_out, B, NF, D, pos, seed, greedy,
                            w_bf16, (cudaStream_t)stream);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
