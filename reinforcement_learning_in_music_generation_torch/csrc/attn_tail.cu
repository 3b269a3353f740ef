// The post-attention half of a training layer, forward and backward: the
// CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/ffn_block.py
// attn_tail_block (its Pallas bodies _tail_fwd_kernel and _tail_bwd_kernel).
//
//   h1  = LN1(h_in + drop1(a_pre @ Wo + bo))
//   out = LN2(h1 + drop3(drop2(gelu(h1 @ W1 + b1)) @ W2 + b2))
//
// Forward, one stream, in order (the GEMMs and row kernels of train_gemm.cuh;
// everything after LN1 is ffn_tail.cuh, shared with ffn_block.cu):
//   gemm  r1 = h_in + drop1(a_pre @ Wo + bo)          bias, mask, residual in the epilogue
//   ln    h1 = LN1(r1)
//   gemm  d2 = drop2(gelu(h1 @ W1 + b1))              (x1 = h1 @ W1 + b1 kept for the backward)
//   gemm  r2 = h1 + drop3(d2 @ W2 + b2)
//   ln    out = LN2(r2)
// Backward recomputes all of that from (h_in, a_pre) and the seed, the only
// tensors saved, as the TPU kernel does, then
//   ln_bwd  dr2, dx2 = dr2 * m3, dLN2           gemm_tn dW2 = d2^T dx2, colsum db2
//   gemm    dx1 = (dx2 @ W2^T) * m2 * gelu'(x1) gemm_tn dW1 = h1^T dx1, colsum db1
//   gemm    dh1 = dx1 @ W1^T + dr2
//   ln_bwd  dh_in, da = dh_in * m1, dLN1        gemm_tn dWo = a_pre^T da, colsum dbo
//   gemm    da_pre = da @ Wo^T
// The TPU accumulated dW across its sequential row tiles; blocks on the card
// have no order, so each dW is a product with K = rows, split along K, and
// the slices are added in a fixed order by a second pass: no atomics, so
// gradients are bit-reproducible.  The (N, DI) intermediates x1, d2, dx1 are
// materialised in the scratch buffer (3 x 128 MB in f32 at N = 16384, DI =
// 2048; rlmg_tail_scratch_floats gives the total).
//
// Bound on the card (PERF.md).  At N = 16384 rows, D = 512, DI = 2048 the
// forward does 2N(D^2 + 2 D DI) = 77.3 GFLOP and moves ~0.11 GB of inputs,
// outputs and weights: operations bind (1.15 ms at 67 TFLOP/s, f32 outside
// the tensor cores).  The backward recomputes the forward and does two more
// products per weight (~232 GFLOP, ~3.5 ms).  This design keeps every
// elementwise step (bias, gelu, dropout, residual) inside a GEMM epilogue or
// a LayerNorm row pass, so the (N, DI) activations cross memory only where a
// later product reads them; the products are f32 FMA tiles, without tensor
// cores yet.

#include "ffn_tail.cuh"

namespace rlmg {

// Weight pointers, in the order of the JAX signature.
enum { T_WO, T_BO, T_L1S, T_L1B, T_W1, T_B1, T_W2, T_B2, T_L2S, T_L2B, N_TAIL_W };
// Gradient pointers: dh_in, da_pre, then the ten parameter gradients.
enum { G_DH, G_DAP, G_DWO, G_DBO, G_DL1S, G_DL1B, G_DW1, G_DB1, G_DW2, G_DB2, G_DL2S, G_DL2B,
       N_TAIL_G };

inline size_t tail_part_floats(int N, int D, int DI) {
  const size_t a = tn_part_floats(D, D, N), b = ffn_part_floats(N, D, DI);
  return a > b ? a : b;
}

// Forward: r1, h1, d2, r2 (N x D, N x D, N x DI, N x D).
// Backward: r1, h1, x1, d2, r2, dr2, dx2, dx1, dh1, da, then the partial sums.
inline size_t tail_scratch_floats(int N, int D, int DI, int backward) {
  const size_t nd = (size_t)N * D, ndi = (size_t)N * DI;
  if (!backward) return 3 * nd + ndi;
  return 7 * nd + 3 * ndi + tail_part_floats(N, D, DI);
}

inline FfnW ffn_weights(const float* const* w) {
  return {w[T_W1], w[T_B1], w[T_W2], w[T_B2], w[T_L2S], w[T_L2B]};
}

struct TailFwd {
  float *r1, *h1, *x1, *d2, *r2;   // x1 may be null (forward only)
};

inline int tail_forward(const float* h_in, const float* a_pre, const float* const* w,
                        const TailFwd& b, const int* seed, float p, float inv, int mid_drop,
                        int N, int D, int DI, cudaStream_t st) {
  Epi<float, float> e1;
  e1.out = b.r1;
  e1.bias = w[T_BO];
  e1.drop = site(seed, 1, p, inv);
  e1.resid = h_in;
  int rc = gemm<false, false>(a_pre, w[T_WO], N, D, D, e1, st);
  if (rc) return rc;
  rc = ln_fwd(b.r1, w[T_L1S], w[T_L1B], b.h1, N, D, st);
  if (rc) return rc;
  return ffn_forward(b.h1, ffn_weights(w), b.x1, b.d2, b.r2, seed, p, inv, mid_drop, N, D, DI,
                     st);
}

}  // namespace rlmg

extern "C" {

// f32 scratch floats of one forward (backward = 0) or backward call.
long long rlmg_tail_scratch_floats(int N, int D, int DI, int backward) {
  return (long long)rlmg::tail_scratch_floats(N, D, DI, backward);
}

// out (N, D) = the tail of (h_in, a_pre).  w: the ten weight pointers in
// T_WO..T_L2B order, all f32 and contiguous.  seed: device pointer to the
// int32 dropout seed; p the rate, inv = 1/(1-p); mid_drop = 0 skips the
// post-gelu site.  Returns 0 or the first CUDA error code.
int rlmg_attn_tail_fwd(const float* h_in, const float* a_pre, const float* const* w, float* out,
                       float* scratch, const int* seed, float p, float inv, int mid_drop, int N,
                       int D, int DI, void* stream) {
  using namespace rlmg;
  if (D % 4 || DI % 4 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t nd = (size_t)N * D;
  TailFwd b;
  b.r1 = scratch;
  b.h1 = b.r1 + nd;
  b.r2 = b.h1 + nd;
  b.d2 = b.r2 + nd;
  b.x1 = nullptr;
  int rc = tail_forward(h_in, a_pre, w, b, seed, p, inv, mid_drop, N, D, DI, st);
  if (rc) return rc;
  return ln_fwd(b.r2, w[T_L2S], w[T_L2B], out, N, D, st);
}

// The twelve gradients of the tail (grads: G_DH..G_DL2B order, f32), from
// the upstream gradient dout (N, D).
int rlmg_attn_tail_bwd(const float* h_in, const float* a_pre, const float* const* w,
                       const float* dout, float* const* grads, float* scratch, const int* seed,
                       float p, float inv, int mid_drop, int N, int D, int DI, void* stream) {
  using namespace rlmg;
  if (D % 4 || DI % 4 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t nd = (size_t)N * D, ndi = (size_t)N * DI;
  TailFwd b;
  b.r1 = scratch;
  b.h1 = b.r1 + nd;
  b.r2 = b.h1 + nd;
  float* dr2 = b.r2 + nd;
  float* dx2 = dr2 + nd;
  float* dh1 = dx2 + nd;
  float* da = dh1 + nd;
  b.x1 = da + nd;
  b.d2 = b.x1 + ndi;
  float* dx1 = b.d2 + ndi;
  float* part = dx1 + ndi;
  int rc = tail_forward(h_in, a_pre, w, b, seed, p, inv, mid_drop, N, D, DI, st);
  if (rc) return rc;
  float* const* g = grads;

  // LN2 and the FFN (ffn_tail.cuh), back to h1
  const FfnG fg = {dh1, g[G_DW1], g[G_DB1], g[G_DW2], g[G_DB2], g[G_DL2S], g[G_DL2B]};
  rc = ffn_backward(b.h1, ffn_weights(w), b.x1, b.d2, b.r2, dout, fg, dr2, dx2, dx1, part, seed,
                    p, inv, mid_drop, N, D, DI, st);
  if (rc) return rc;
  // LN1, dropout 1, Wo
  rc = ln_bwd(b.r1, dh1, w[T_L1S], g[G_DH], da, site(seed, 1, p, inv), g[G_DL1S], g[G_DL1B], N, D,
              part, st);
  if (rc) return rc;
  if ((rc = colsum(da, g[G_DBO], N, D, part, st))) return rc;
  if ((rc = gemm_tn(a_pre, da, g[G_DWO], D, D, N, part, st))) return rc;
  Epi<float, float> e3;
  e3.out = g[G_DAP];
  return gemm<false, true>(da, w[T_WO], N, D, D, e3, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
