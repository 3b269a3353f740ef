// The post-attention half of a training layer, forward and backward: the
// CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/ffn_block.py
// attn_tail_block (its Pallas bodies _tail_fwd_kernel and _tail_bwd_kernel).
//
//   h1  = LN1(h_in + drop1(a_pre @ Wo + bo))
//   out = LN2(h1 + drop3(drop2(gelu(h1 @ W1 + b1)) @ W2 + b2))
//
// Forward, one stream, in order (the products and row kernels of train_gemm_tc.cuh;
// everything after LN1 is ffn_tail.cuh, shared with ffn_block.cu):
//   split a_pre, Wo, W1, W2 into bf16 planes        f32 tensors only
//   gemm  r1 = h_in + drop1(a_pre @ Wo + bo)          bias, mask, residual in the epilogue
//   ln    h1 = LN1(r1)
//   gemm  d2 = drop2(gelu(h1 @ W1 + b1))              (x1 = h1 @ W1 + b1 kept for the backward)
//   gemm  r2 = h1 + drop3(d2 @ W2 + b2)
//   ln    out = LN2(r2)
// Backward recomputes all of that from (h_in, a_pre) and the seed, the only
// tensors saved, as the TPU kernel does, then
//   ln_bwd  dr2, dx2 = dr2 * m3, dLN2           gemm dW2 = d2^T dx2, colsum db2
//   gemm    dx1 = (dx2 @ W2^T) * m2 * gelu'(x1) gemm dW1 = h1^T dx1, colsum db1
//   gemm    dh1 = dx1 @ W1^T + dr2
//   ln_bwd  dh_in, da = dh_in * m1, dLN1        gemm dWo = a_pre^T da, colsum dbo
//   gemm    da_pre = da @ Wo^T
// The TPU accumulated dW across its sequential row tiles; blocks on the card
// have no order, so each dW is a product with K = rows, split along K, and
// the slices are added in a fixed order by a second pass: no atomics, so
// gradients are bit-reproducible.  The (N, DI) intermediates x1, d2, dx1 are
// materialised in the scratch buffer (x1 and dx1 in f32, d2 and dx1 as
// operand planes: 4 x 128 MB at N = 16384, DI = 2048 on f32 tensors;
// rlmg_tail_scratch_floats gives the total).
//
// f32 or bf16 tensors, one type for the inputs and the ten parameters
// (ffn_tail.cuh says what each arithmetic rounds and what is stored in
// which type); the output and the gradients come back in that type.
//
// Bound on the card (PERF.md).  At N = 16384 rows, D = 512, DI = 2048 the
// forward does 2N(D^2 + 2 D DI) = 77.3 GFLOP and moves ~0.11 GB of f32
// inputs, outputs and weights: operations bind, 0.078 ms at the bf16 tensor
// cores' 989 TFLOP/s, 0.47 ms for the f32 route's six bf16 products a
// product.  The backward recomputes the forward and does two more products
// per weight.  This design keeps every elementwise step (bias, gelu,
// dropout, residual) inside a product's epilogue or a LayerNorm row pass, so
// the (N, DI) activations cross memory only where a later product reads
// them, and runs every product on the tensor cores (train_gemm_tc.cuh).

#include "ffn_tail.cuh"

namespace rlmg {

// Weight pointers, in the order of the JAX signature.
enum { T_WO, T_BO, T_L1S, T_L1B, T_W1, T_B1, T_W2, T_B2, T_L2S, T_L2B, N_TAIL_W };
// Gradient pointers: dh_in, da_pre, then the ten parameter gradients.
enum { G_DH, G_DAP, G_DWO, G_DBO, G_DL1S, G_DL1B, G_DW1, G_DB1, G_DW2, G_DB2, G_DL2S, G_DL2B,
       N_TAIL_G };

template <typename T>
FfnW<T> ffn_weights(const T* const* w) {
  return {w[T_W1], w[T_B1], w[T_W2], w[T_B2], w[T_L2S], w[T_L2B]};
}

// A call's buffers in its scratch (Scratch: the same function counts them).
struct TailBufs {
  SplitJobs jobs;
  TtOp ap, wo;               // a_pre and Wo as operands
  float *r1, *h1;            // (N, D): LN1's input and output
  TtPlanes h1p;              // h1 as FFN1's and dW1's operand
  FfnBufs f;
  float *dh1, *da;           // backward (N, D)
  TtPlanes dap;              // da as dWo's and da_pre's operand
  float* part;
};

template <typename T>
TailBufs tail_layout(Scratch& sc, const T* a_pre, const T* const* w, int N, int D, int DI,
                     bool backward) {
  constexpr bool split = planes_of<T>() == 3;
  const size_t nd = (size_t)N * D;
  TailBufs b = {};
  b.ap = operand(a_pre, sc, nd, b.jobs);
  b.wo = operand(w[T_WO], sc, (size_t)D * D, b.jobs);
  b.r1 = sc.take(nd);
  b.h1 = sc.take(nd);
  b.h1p = sc.planes(nd, split);
  b.f = ffn_layout(sc, b.jobs, ffn_weights(w), N, D, DI, backward);
  if (backward) {
    b.dh1 = sc.take(nd);
    b.da = sc.take(nd);
    b.dap = sc.planes(nd, split);
  }
  size_t part = ffn_part_floats(N, D, DI);
  const size_t c[3] = {tt_part_floats(N, D, D), tt_part_floats(D, D, N), ln_bwd_part_floats(N, D)};
  for (size_t v : c) part = v > part ? v : part;
  b.part = sc.take(part);
  return b;
}

template <typename T>
size_t tail_scratch_floats(int N, int D, int DI, int backward) {
  const T* w[N_TAIL_W] = {};
  Scratch sc = {nullptr};
  tail_layout<T>(sc, nullptr, w, N, D, DI, backward);
  return sc.used;
}

// r1, h1 and the FFN's forward buffers of (h_in, a_pre).
template <typename T>
int tail_forward(const T* h_in, const T* const* w, const TailBufs& b, const int* seed, float p,
                 float inv, int mid_drop, int N, int D, int DI, cudaStream_t st) {
  int rc = split_all(b.jobs, st);
  if (rc) return rc;
  TcEpi<T, float, T> e1;
  e1.out = b.r1;
  e1.bias = w[T_BO];
  e1.drop = site(seed, 1, p, inv);
  e1.resid = h_in;
  if ((rc = tt_gemm<false, false, planes_of<T>()>(b.ap, b.wo, N, D, D, e1, b.part, st)))
    return rc;
  if ((rc = ln_fwd(b.r1, w[T_L1S], w[T_L1B], b.h1, N, D, st, b.h1p))) return rc;
  return ffn_forward(op(b.h1p), static_cast<const float*>(b.h1), ffn_weights(w), b.f, b.part,
                     seed, p, inv, mid_drop, N, D, DI, st);
}

template <typename T>
int tail_fwd(const T* h_in, const T* a_pre, const T* const* w, T* out, float* scratch,
             const int* seed, float p, float inv, int mid_drop, int N, int D, int DI,
             cudaStream_t st) {
  Scratch sc = {scratch};
  const TailBufs b = tail_layout(sc, a_pre, w, N, D, DI, false);
  int rc = tail_forward(h_in, w, b, seed, p, inv, mid_drop, N, D, DI, st);
  if (rc) return rc;
  return ln_fwd(b.f.r, w[T_L2S], w[T_L2B], out, N, D, st);
}

template <typename T>
int tail_bwd(const T* h_in, const T* a_pre, const T* const* w, const T* dout, T* const* g,
             float* scratch, const int* seed, float p, float inv, int mid_drop, int N, int D,
             int DI, cudaStream_t st) {
  constexpr int PL = planes_of<T>();
  Scratch sc = {scratch};
  const TailBufs b = tail_layout(sc, a_pre, w, N, D, DI, true);
  int rc = tail_forward(h_in, w, b, seed, p, inv, mid_drop, N, D, DI, st);
  if (rc) return rc;
  // LN2 and the FFN (ffn_tail.cuh), back to h1
  const FfnG<T> fg = {g[G_DW1], g[G_DB1], g[G_DW2], g[G_DB2], g[G_DL2S], g[G_DL2B]};
  rc = ffn_backward(op(b.h1p), ffn_weights(w), b.f, dout, b.dh1, fg, b.part, seed, p, inv,
                    mid_drop, N, D, DI, st);
  if (rc) return rc;
  // LN1, dropout 1, Wo
  rc = ln_bwd(b.r1, static_cast<const float*>(b.dh1), w[T_L1S], g[G_DH], b.da, b.dap,
              site(seed, 1, p, inv), g[G_DL1S], g[G_DL1B], N, D, b.part, st);
  if (rc) return rc;
  if ((rc = colsum(b.da, g[G_DBO], N, D, b.part, st))) return rc;
  TcEpi<T, T, float> ew;
  ew.out = g[G_DWO];
  if ((rc = tt_gemm<true, false, PL>(b.ap, op(b.dap), D, D, N, ew, b.part, st))) return rc;
  TcEpi<T, T, float> e3;
  e3.out = g[G_DAP];
  return tt_gemm<false, true, PL>(op(b.dap), b.wo, N, D, D, e3, b.part, st);
}

}  // namespace rlmg

extern "C" {

// CUDA launches this library has issued since it was loaded.
long long rlmg_cuda_launches() { return rlmg::tt_launches(); }

// f32 scratch floats of one forward (backward = 0) or backward call on f32
// (bf16 = 0) or bf16 (bf16 = 1) tensors.
long long rlmg_tail_scratch_floats(int N, int D, int DI, int backward, int bf16) {
  return (long long)(bf16 ? rlmg::tail_scratch_floats<__nv_bfloat16>(N, D, DI, backward)
                          : rlmg::tail_scratch_floats<float>(N, D, DI, backward));
}

// out (N, D) = the tail of (h_in, a_pre).  w: the ten weight pointers in
// T_WO..T_L2B order; every tensor contiguous, f32 (bf16 = 0) or bf16
// (bf16 = 1).  seed: device pointer to the int32 dropout seed; p the rate,
// inv = 1/(1-p); mid_drop = 0 skips the post-gelu site.  Returns 0 or the
// first CUDA error code.
int rlmg_attn_tail_fwd(const void* h_in, const void* a_pre, const void* const* w, void* out,
                       float* scratch, const int* seed, float p, float inv, int mid_drop, int N,
                       int D, int DI, int bf16, void* stream) {
  using namespace rlmg;
  if (D % 8 || DI % 8 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tail_fwd((const __nv_bfloat16*)h_in, (const __nv_bfloat16*)a_pre,
                    (const __nv_bfloat16* const*)w, (__nv_bfloat16*)out, scratch, seed, p, inv,
                    mid_drop, N, D, DI, st);
  return tail_fwd((const float*)h_in, (const float*)a_pre, (const float* const*)w, (float*)out,
                  scratch, seed, p, inv, mid_drop, N, D, DI, st);
}

// The twelve gradients of the tail (grads: G_DH..G_DL2B order, in the
// tensors' type), from the upstream gradient dout (N, D).
int rlmg_attn_tail_bwd(const void* h_in, const void* a_pre, const void* const* w,
                       const void* dout, void* const* grads, float* scratch, const int* seed,
                       float p, float inv, int mid_drop, int N, int D, int DI, int bf16,
                       void* stream) {
  using namespace rlmg;
  if (D % 8 || DI % 8 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tail_bwd((const __nv_bfloat16*)h_in, (const __nv_bfloat16*)a_pre,
                    (const __nv_bfloat16* const*)w, (const __nv_bfloat16*)dout,
                    (__nv_bfloat16* const*)grads, scratch, seed, p, inv, mid_drop, N, D, DI, st);
  return tail_bwd((const float*)h_in, (const float*)a_pre, (const float* const*)w,
                  (const float*)dout, (float* const*)grads, scratch, seed, p, inv, mid_drop, N, D,
                  DI, st);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
