// The post-LN1 half of a training layer, forward and backward: the CUDA
// counterpart of reinforcement_learning_in_music_generation_tpu/ops/ffn_block.py
// ffn_block (its Pallas bodies _fwd_kernel and _bwd_kernel).
//
//   out = LN2(h + drop3(drop2(gelu(h @ W1 + b1)) @ W2 + b2))
//
// Kernel D (attn_tail.cu) without its Wo + LN1 head: the forward is
// ffn_tail.cuh's two GEMMs, then LN2; the backward recomputes them from h
// and the seed, the only tensors saved (as the TPU kernel does), then runs
// ffn_tail.cuh's backward.  The TPU kernel padded the rows to its 256-row
// block; here every launch masks its own ragged edge, and the dropout masks
// key on the absolute row, so any N is taken as it is (one rollout state,
// N = 50, included).
//
// Bound on the card (PERF.md).  The forward does 4 N D DI operations, the
// backward 12 N D DI (the recomputed forward and two products per weight).
// At N = 1500 rows (a PPO update), D = 512, DI = 2048 that is 6.3 / 18.9
// GFLOP: operations bind (0.094 / 0.28 ms at 67 TFLOP/s, f32 outside the
// tensor cores).  At N = 50 (a rollout state) the 8.4 MB of weights take
// 2.5 us against 3.1 us of operations, so both nearly bind, and the
// 16 x 1 tile grid of the first product leaves most SMs idle.  The design
// keeps every elementwise step inside a GEMM epilogue or the LayerNorm row
// pass; the products are f32 FMA tiles, without tensor cores yet.

#include "ffn_tail.cuh"

namespace rlmg {

// Forward: d2 (N x DI), r (N x D).
// Backward: x1, d2, dx1 (N x DI), r, dr, dx2 (N x D), then the partial sums.
inline size_t ffn_scratch_floats(int N, int D, int DI, int backward) {
  const size_t nd = (size_t)N * D, ndi = (size_t)N * DI;
  if (!backward) return nd + ndi;
  return 3 * nd + 3 * ndi + ffn_part_floats(N, D, DI);
}

}  // namespace rlmg

extern "C" {

// f32 scratch floats of one forward (backward = 0) or backward call.
long long rlmg_ffn_scratch_floats(int N, int D, int DI, int backward) {
  return (long long)rlmg::ffn_scratch_floats(N, D, DI, backward);
}

// out (N, D) = LN2(h + FFN(h)).  w: w1, b1, w2, b2, ln_scale, ln_bias, all
// f32 and contiguous.  seed: device pointer to the int32 dropout seed; p
// the rate, inv = 1/(1-p).  Returns 0 or the first CUDA error code.
int rlmg_ffn_fwd(const float* h, const float* const* w, float* out, float* scratch,
                 const int* seed, float p, float inv, int N, int D, int DI, void* stream) {
  using namespace rlmg;
  if (D % 4 || DI % 4 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const FfnW fw = {w[0], w[1], w[2], w[3], w[4], w[5]};
  float* d2 = scratch;
  float* r = d2 + (size_t)N * DI;
  int rc = ffn_forward(h, fw, nullptr, d2, r, seed, p, inv, 1, N, D, DI, st);
  if (rc) return rc;
  return ln_fwd(r, fw.ln_s, fw.ln_b, out, N, D, st);
}

// The seven gradients (grads: dh, dw1, db1, dw2, db2, dln_scale, dln_bias,
// f32), from the upstream gradient dout (N, D).
int rlmg_ffn_bwd(const float* h, const float* const* w, const float* dout, float* const* grads,
                 float* scratch, const int* seed, float p, float inv, int N, int D, int DI,
                 void* stream) {
  using namespace rlmg;
  if (D % 4 || DI % 4 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t nd = (size_t)N * D, ndi = (size_t)N * DI;
  const FfnW fw = {w[0], w[1], w[2], w[3], w[4], w[5]};
  const FfnG fg = {grads[0], grads[1], grads[2], grads[3], grads[4], grads[5], grads[6]};
  float* x1 = scratch;
  float* d2 = x1 + ndi;
  float* dx1 = d2 + ndi;
  float* r = dx1 + ndi;
  float* dr = r + nd;
  float* dx2 = dr + nd;
  float* part = dx2 + nd;
  int rc = ffn_forward(h, fw, x1, d2, r, seed, p, inv, 1, N, D, DI, st);
  if (rc) return rc;
  return ffn_backward(h, fw, x1, d2, r, dout, fg, dr, dx2, dx1, part, seed, p, inv, 1, N, D, DI,
                      st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
