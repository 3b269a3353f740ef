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
// f32 or bf16 tensors, one type for h and the six parameters; the output
// and the gradients come back in that type (ffn_tail.cuh: the arithmetic).
//
// Bound on the card (PERF.md).  The forward does 4 N D DI operations, the
// backward 8 N D DI (two products per weight; the recomputed forward is
// the design's extra 4 N D DI).  At N = 1500 rows (a PPO update), D = 512,
// DI = 2048, 6.3 GFLOP forward: operations bind (0.0064 ms at 989 TFLOP/s
// in bf16, 0.038 ms for the f32 route's six bf16 products).  At N = 50
// (a rollout state) the weights bind: 8.4 MB in f32 (2.5 us), 4.2 MB in
// bf16.  The design keeps every elementwise step inside a product's
// epilogue or the LayerNorm row pass and runs the products on the tensor
// cores: at 50 rows on 64 x 32 tiles split along K until about two blocks
// an SM are in flight (train_gemm_tc.cuh tt_plan), so the weights stream
// through the whole card; at 1500 rows on 128 x 128 tiles.
//
// rlmg_tile_product exposes the product tile alone, for its own checks
// (the card-only tests and chip_smoke.py); kernel G's path does not use it.

#include "ffn_tail.cuh"

namespace rlmg {

// A call's buffers in its scratch (Scratch: the same function counts them).
struct FfnCall {
  SplitJobs jobs;
  TtOp h;                    // h as FFN1's and dW1's operand
  FfnBufs f;
  float* part;
};

template <typename T>
FfnCall ffn_call_layout(Scratch& sc, const T* h, const FfnW<T>& w, int N, int D, int DI,
                        bool backward) {
  FfnCall c = {};
  c.h = operand(h, sc, (size_t)N * D, c.jobs);
  c.f = ffn_layout(sc, c.jobs, w, N, D, DI, backward);
  c.part = sc.take(ffn_part_floats(N, D, DI));
  return c;
}

template <typename T>
size_t ffn_scratch_floats(int N, int D, int DI, int backward) {
  Scratch sc = {nullptr};
  ffn_call_layout<T>(sc, nullptr, FfnW<T>{}, N, D, DI, backward);
  return sc.used;
}

template <typename T>
int ffn_fwd(const T* h, const T* const* w, T* out, float* scratch, const int* seed, float p,
            float inv, int N, int D, int DI, cudaStream_t st) {
  const FfnW<T> fw = {w[0], w[1], w[2], w[3], w[4], w[5]};
  Scratch sc = {scratch};
  const FfnCall c = ffn_call_layout(sc, h, fw, N, D, DI, false);
  int rc = split_all(c.jobs, st);
  if (rc) return rc;
  if ((rc = ffn_forward(c.h, h, fw, c.f, c.part, seed, p, inv, 1, N, D, DI, st))) return rc;
  return ln_fwd(c.f.r, fw.ln_s, fw.ln_b, out, N, D, st, TtPlanes{}, 1);   // counts the run
}

template <typename T>
int ffn_bwd(const T* h, const T* const* w, const T* dout, T* const* grads, float* scratch,
            const int* seed, float p, float inv, int N, int D, int DI, cudaStream_t st) {
  const FfnW<T> fw = {w[0], w[1], w[2], w[3], w[4], w[5]};
  const FfnG<T> fg = {grads[1], grads[2], grads[3], grads[4], grads[5], grads[6]};
  Scratch sc = {scratch};
  const FfnCall c = ffn_call_layout(sc, h, fw, N, D, DI, true);
  int rc = split_all(c.jobs, st);
  if (rc) return rc;
  if ((rc = ffn_forward(c.h, h, fw, c.f, c.part, seed, p, inv, 1, N, D, DI, st))) return rc;
  return ffn_backward(c.h, fw, c.f, dout, grads[0], fg, c.part, seed, p, inv, 1, N, D, DI, st);
}

// C (M, N) f32 = op(A) @ op(B) on the product tile, A and B of type T.
template <bool A_T, bool B_T, typename T>
int tile_product(const T* a, const T* b, float* c, int M, int N, int K, float* scratch,
                 cudaStream_t st) {
  Scratch sc = {scratch};
  SplitJobs jobs;
  const TtOp A = operand(a, sc, (size_t)M * K, jobs), B = operand(b, sc, (size_t)K * N, jobs);
  int rc = split_all(jobs, st);
  if (rc) return rc;
  TcEpi<T, float, float> e;
  e.out = c;
  return tt_gemm<A_T, B_T, planes_of<T>()>(A, B, M, N, K, e, sc.take(tt_part_floats(M, N, K)),
                                           st);
}

template <typename T>
int tile_product_layout(const T* a, const T* b, float* c, int M, int N, int K, int a_t, int b_t,
                        float* scratch, cudaStream_t st) {
  if (a_t && !b_t) return tile_product<true, false>(a, b, c, M, N, K, scratch, st);
  if (!a_t && b_t) return tile_product<false, true>(a, b, c, M, N, K, scratch, st);
  if (!a_t && !b_t) return tile_product<false, false>(a, b, c, M, N, K, scratch, st);
  return (int)cudaErrorInvalidValue;        // (A^T, B^T): no kernel uses it
}

}  // namespace rlmg

extern "C" {

// f32 scratch floats of rlmg_tile_product at (M, N, K).
long long rlmg_tile_scratch_floats(int M, int N, int K) {
  using namespace rlmg;
  Scratch sc = {nullptr};
  SplitJobs jobs;
  operand((const float*)nullptr, sc, (size_t)M * K, jobs);     // f32: the larger layout
  operand((const float*)nullptr, sc, (size_t)K * N, jobs);
  sc.take(tt_part_floats(M, N, K));
  return (long long)sc.used;
}

// c (M, N) f32 = op(a) @ op(b) on the training product tile: a is (M, K),
// or (K, M) with a_t; b is (K, N), or (N, K) with b_t; both f32 (bf16 = 0,
// the split arithmetic) or both bf16, contiguous, with the contiguous
// dimensions multiples of 8.  Returns 0 or the first CUDA error code.
int rlmg_tile_product(const void* a, const void* b, float* c, float* scratch, int M, int N,
                      int K, int a_t, int b_t, int bf16, void* stream) {
  using namespace rlmg;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tile_product_layout((const __nv_bfloat16*)a, (const __nv_bfloat16*)b, c, M, N, K,
                               a_t, b_t, scratch, st);
  return tile_product_layout((const float*)a, (const float*)b, c, M, N, K, a_t, b_t, scratch,
                             st);
}

// CUDA launches this library has issued since it was loaded.
long long rlmg_cuda_launches() { return rlmg::tt_launches(); }

// f32 scratch floats of one forward (backward = 0) or backward call on f32
// (bf16 = 0) or bf16 (bf16 = 1) tensors.
long long rlmg_ffn_scratch_floats(int N, int D, int DI, int backward, int bf16) {
  return (long long)(bf16 ? rlmg::ffn_scratch_floats<__nv_bfloat16>(N, D, DI, backward)
                          : rlmg::ffn_scratch_floats<float>(N, D, DI, backward));
}

// out (N, D) = LN2(h + FFN(h)).  w: w1, b1, w2, b2, ln_scale, ln_bias;
// every tensor contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1).  seed:
// device pointer to the int32 dropout seed; p the rate, inv = 1/(1-p).
// Returns 0 or the first CUDA error code.
int rlmg_ffn_fwd(const void* h, const void* const* w, void* out, float* scratch, const int* seed,
                 float p, float inv, int N, int D, int DI, int bf16, void* stream) {
  using namespace rlmg;
  if (D % 8 || DI % 8 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return ffn_fwd((const __nv_bfloat16*)h, (const __nv_bfloat16* const*)w, (__nv_bfloat16*)out,
                   scratch, seed, p, inv, N, D, DI, st);
  return ffn_fwd((const float*)h, (const float* const*)w, (float*)out, scratch, seed, p, inv, N,
                 D, DI, st);
}

// The seven gradients (grads: dh, dw1, db1, dw2, db2, dln_scale, dln_bias,
// in the tensors' type), from the upstream gradient dout (N, D).
int rlmg_ffn_bwd(const void* h, const void* const* w, const void* dout, void* const* grads,
                 float* scratch, const int* seed, float p, float inv, int N, int D, int DI,
                 int bf16, void* stream) {
  using namespace rlmg;
  if (D % 8 || DI % 8 || D > LN_MAX_D) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return ffn_bwd((const __nv_bfloat16*)h, (const __nv_bfloat16* const*)w,
                   (const __nv_bfloat16*)dout, (__nv_bfloat16* const*)grads, scratch, seed, p,
                   inv, N, D, DI, st);
  return ffn_bwd((const float*)h, (const float* const*)w, (const float*)dout,
                 (float* const*)grads, scratch, seed, p, inv, N, D, DI, st);
}

// Forward calls that ran to their end on the current card since the last
// reset, as the kernel counts them (its last launch, graph replays
// included).  Waits for the card; reset zeroes the count after the read.
// Returns 0 or a CUDA error code.
int rlmg_ffn_runs(long long* runs, int reset) {
  unsigned long long n = 0;
  cudaError_t e = cudaMemcpyFromSymbol(&n, rlmg::tt_ln_runs, sizeof n);
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(rlmg::tt_ln_runs, &zero, sizeof zero);
  }
  *runs = (long long)n;
  return (int)e;
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
