// qkv projection + chunked causal linear attention, forward and backward
// ("kernel C"): the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/attention_block.py
// qkv_attention_block (its Pallas bodies _fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel), in JAX's arithmetic at f32 and at bf16.
//
// Projection (rlmg_qkv_project): pqkv = [phi(q) | phi(k) | v] = h Wqkv + b
// with phi = elu + 1 on the first 2D columns, on the wgmma tile of
// train_gemm_wg.cuh (f32 tensors: six bf16 products a depth from three
// planes an operand; bf16: one bf16 product, f32 sums).  pqkv, in h's
// type, is the backward's residual, as on the TPU.  At bf16 the epilogue
// also writes the unrounded f32 values (xqkv): JAX's kernel attends on
// its f32 projection and rounds only what it stores, so the attention
// reads xqkv (a transient 4 N 3D bytes, 100 MB at 16384 x 1536, about
// 0.06 ms of traffic; chosen over rounding the residual inside the
// attention pass, which would have the passes write pqkv for rows their
// tile only reads).  At f32 the two are one array.
//
// Attention (rlmg_qkv_attn_fwd, rlmg_qkv_attn_bwd): the passes of
// causal_product.cuh, kernel F's, on (B, H, S, E) views of the packed rows
// (strides (S 3D, E, 3D)): the forward reads f32 and writes att in h's
// type and den (B, H, S) f32; the backward reads pqkv, g and att in h's
// type and writes dqkv (N, 3D) in h's type, with phi' = min(phi, 1) of the
// stored phi folded into d phi(q) and d phi(k) by the pass that writes
// them (JAX's _qab_bwd).  dh = dqkv W^T, dW = h^T dqkv and db stay
// outside, as JAX leaves them to XLA.  The TPU kernel's head-pair packing
// (128-lane rows) has no purpose here and is dropped; its chunk is the
// plain twin's, a numerics-free choice of the tile here.
//
// Bound on the card (PERF.md).  At N = 16384 rows, D = 512, 8 heads of 64:
// the projection is 2 N D 3D = 25.8 GFLOP, 0.026 ms at 989 TFLOP/s for
// bf16 tensors and 0.157 ms at 989/6 for f32 (six bf16 products); the
// attention's causal half 3.2 GFLOP forward, its bytes bind (F's bound).

#include "causal_product.cuh"
#include "train_gemm_wg.cuh"

namespace rlmg {

template <typename T>
int qkv_project(const T* h, const T* w, const T* b, T* pqkv, float* xqkv, wg::bf16* planes,
                int N, int D, cudaStream_t st) {
  const wg::Epi<T> e{b, pqkv, xqkv, 2 * D};
  return wg::gemm<T>(h, w, N, 3 * D, D, e, planes, st);
}

// The heads of the packed (N, 3D) rows at column offset c as (B, H, S, E).
template <typename X>
cpk::Bhse<X> heads(const X* rows, int c, int S, int width, int E) {
  return cpk::Bhse<X>{rows + c, (long long)S * width, E, width};
}

template <typename T>
int qkv_attn_fwd(const float* x, T* att, float* den, float* scratch, int N, int n_seq, int D,
                 int H, float eps, cudaStream_t st) {
  using A = cpk::Args<float, T>;
  const int E = D / H, S = N / n_seq;
  A a = cpk::make_args<A>(H, S, E, eps, scratch);
  a.q = heads(x, 0, S, 3 * D, E);
  a.k = heads(x, D, S, 3 * D, E);
  a.v = heads(x, 2 * D, S, 3 * D, E);
  a.o = heads<T>(att, 0, S, D, E);
  a.den = den;
  return cpk::forward_any(a, n_seq, st);
}

template <typename T>
int qkv_attn_bwd(const T* pqkv, const T* g, const T* att, const float* den, T* dqkv,
                 float* scratch, int N, int n_seq, int D, int H, float eps, cudaStream_t st) {
  using A = cpk::Args<T, T>;
  const int E = D / H, S = N / n_seq;
  A a = cpk::make_args<A>(H, S, E, eps, scratch);
  a.q = heads(pqkv, 0, S, 3 * D, E);
  a.k = heads(pqkv, D, S, 3 * D, E);
  a.v = heads(pqkv, 2 * D, S, 3 * D, E);
  a.g = heads(g, 0, S, D, E);
  a.o = heads(att, 0, S, D, E);
  a.dq = heads<T>(dqkv, 0, S, 3 * D, E);
  a.dk = heads<T>(dqkv, D, S, 3 * D, E);
  a.dv = heads<T>(dqkv, 2 * D, S, 3 * D, E);
  a.den = const_cast<float*>(den);
  a.fold = 1;
  return cpk::backward_any(a, n_seq, st);
}

inline bool attn_shape_ok(int N, int n_seq, int D, int H) {
  if (H <= 0 || n_seq <= 0 || n_seq > 65535 || H > 65535 || D % H || N % n_seq) return false;
  const int E = D / H;
  return E % 4 == 0 && E <= cpk::MAX_E && D % 8 == 0;
}

}  // namespace rlmg

extern "C" {

// bf16 elements of the planes rlmg_qkv_project splits (h's at f32, W^T's).
long long rlmg_qkv_plane_elems(int N, int D, int bf16) {
  return (long long)rlmg::wg::plane_elems(N, 3 * D, D, !bf16);
}

// f32 scratch floats of an attention call (0 at S <= 64).
long long rlmg_qkv_attn_scratch_floats(int n_seq, int H, int S, int E, int backward) {
  return rlmg::cpk::scratch_floats(n_seq, H, S, E, backward);
}

// h (N, D), w (D, 3D), b (3D) in one type (bf16 = 1: bfloat16, else f32)
// -> pqkv (N, 3D) = [phi(q) | phi(k) | v] in that type and, at bf16, its
// f32 values in xqkv (N, 3D); planes: rlmg_qkv_plane_elems bf16.  Three
// launches at f32 (two splits, the product), two at bf16.  Returns 0 or a
// CUDA error code.
int rlmg_qkv_project(const void* h, const void* w, const void* b, void* pqkv, float* xqkv,
                     void* planes, int N, int D, int bf16, void* stream) {
  using namespace rlmg;
  if (N <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_project<__nv_bfloat16>((const __nv_bfloat16*)h, (const __nv_bfloat16*)w,
                                      (const __nv_bfloat16*)b, (__nv_bfloat16*)pqkv, xqkv,
                                      (__nv_bfloat16*)planes, N, D, st);
  return qkv_project<float>((const float*)h, (const float*)w, (const float*)b, (float*)pqkv,
                            nullptr, (__nv_bfloat16*)planes, N, D, st);
}

// The attention forward on the projection's f32 values x (N, 3D) (at f32
// pqkv itself): att (N, D) in h's type (bf16 = 1: bfloat16) and den
// (n_seq, H, S) f32.  N = n_seq sequences of S = N / n_seq rows; scratch:
// rlmg_qkv_attn_scratch_floats(..., 0).  One launch at S <= 64, else two.
int rlmg_qkv_attn_fwd(const float* x, void* att, float* den, float* scratch, int N, int n_seq,
                      int D, int H, float eps, int bf16, void* stream) {
  using namespace rlmg;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_fwd<__nv_bfloat16>(x, (__nv_bfloat16*)att, den, scratch, N, n_seq, D, H,
                                       eps, st);
  return qkv_attn_fwd<float>(x, (float*)att, den, scratch, N, n_seq, D, H, eps, st);
}

// From the residual pqkv, att, den and the upstream gradient g (N, D), all
// in h's type but den, writes dqkv (N, 3D) = [d phi(q) phi'(q) | d phi(k)
// phi'(k) | dv] in that type; scratch: ..._scratch_floats(..., 1).
int rlmg_qkv_attn_bwd(const void* pqkv, const void* g, const void* att, const float* den,
                      void* dqkv, float* scratch, int N, int n_seq, int D, int H, float eps,
                      int bf16, void* stream) {
  using namespace rlmg;
  using bf = __nv_bfloat16;
  if (!attn_shape_ok(N, n_seq, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return qkv_attn_bwd<bf>((const bf*)pqkv, (const bf*)g, (const bf*)att, den, (bf*)dqkv,
                            scratch, N, n_seq, D, H, eps, st);
  return qkv_attn_bwd<float>((const float*)pqkv, (const float*)g, (const float*)att, den,
                             (float*)dqkv, scratch, N, n_seq, D, H, eps, st);
}

// Attention calls that ran to their end on the current card since the
// last reset, as the kernel counts them (graph replays included): runs[0]
// forward, runs[1] backward; reset zeroes them after the read.
int rlmg_qkv_attn_runs(long long* runs, int reset) {
  return rlmg::cpk::read_runs(runs, reset);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
