// Causal linear-attention product of feature-mapped q and k, forward and
// backward ("kernel F"): the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/linear_attention.py
// _fwd_pallas (Pallas body _fwd_kernel) and _bwd_pallas (_bwd_dq_kernel,
// _bwd_dkv_kernel), which replaced fast_transformers' causal_product.
//
// The passes, their bound and their design: causal_product.cuh (shared
// with kernel C's attention half).  Here they run on (B, H, S, E) views of
// one type T, f32 or bf16 (JAX's kernel takes any dtype and computes in
// f32): phi(q), phi(k), v, out and the gradients with batch / head / row
// strides that are multiples of 4 elements, 16-byte aligned bases and a
// unit last stride, so the (B, H, S, E) views of (B, S, H, E) projections
// go in and come out without copies; den (B, H, S) contiguous, in T.  At
// bf16 the tiles are widened to f32 as they are staged, every product is
// the f32-grade one of the f32 route, out and den are rounded on store,
// and the backward forms dnum and dd in bf16 arithmetic from the rounded
// out and den (Args<bf16, bf16, bf16>), where _fwd_pallas / _bwd_pallas
// round.

#include "causal_product.cuh"

namespace rlmg {
namespace cpk {

template <typename T>
inline Bhse<T> bhse(const void* p, const long long* s) {
  return Bhse<T>{(const T*)p, s[0], s[1], s[2]};
}

template <typename T>
int fwd(const void* pq, const void* pk, const void* v, void* out, void* den, float* scratch,
        const long long* strides, int B, int H, int S, int E, float eps, cudaStream_t st) {
  using A = Args<T, T, T>;
  A a = make_args<A>(H, S, E, eps, scratch);
  a.q = bhse<T>(pq, strides);
  a.k = bhse<T>(pk, strides + 3);
  a.v = bhse<T>(v, strides + 6);
  a.o = bhse<T>(out, strides + 9);
  a.den = (T*)den;
  return forward_any(a, B, st);
}

template <typename T>
int bwd(const void* pq, const void* pk, const void* v, const void* out, const void* den,
        const void* g, void* dq, void* dk, void* dv, float* scratch, const long long* strides,
        int B, int H, int S, int E, float eps, cudaStream_t st) {
  using A = Args<T, T, T>;
  A a = make_args<A>(H, S, E, eps, scratch);
  a.q = bhse<T>(pq, strides);
  a.k = bhse<T>(pk, strides + 3);
  a.v = bhse<T>(v, strides + 6);
  a.o = bhse<T>(out, strides + 9);
  a.g = bhse<T>(g, strides + 12);
  a.dq = bhse<T>(dq, strides + 15);
  a.dk = bhse<T>(dk, strides + 18);
  a.dv = bhse<T>(dv, strides + 21);
  a.den = (T*)const_cast<void*>(den);
  return backward_any(a, B, st);
}

}  // namespace cpk
}  // namespace rlmg

extern "C" {

// f32 scratch floats a call at these shapes needs (0 at S <= 64): the
// prefix (and, backward, suffix) state of each tile.
long long rlmg_causal_product_scratch_floats(int B, int H, int S, int E, int backward) {
  return rlmg::cpk::scratch_floats(B, H, S, E, backward);
}

// phi(q), phi(k), v (B, H, S, E) -> out (B, H, S, E) and den (B, H, S),
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).  strides: (batch, head, row)
// of phi(q), phi(k), v, out, in elements; scratch:
// rlmg_causal_product_scratch_floats(..., 0) floats.  One launch at S <=
// 64, else two (the state pass first).  Returns 0 or a CUDA error code.
int rlmg_causal_product_fwd(const void* pq, const void* pk, const void* v, void* out, void* den,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, int is_bf16, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return fwd<__nv_bfloat16>(pq, pk, v, out, den, scratch, strides, B, H, S, E, eps, st);
  return fwd<float>(pq, pk, v, out, den, scratch, strides, B, H, S, E, eps, st);
}

// From the forward's inputs, out and den and the upstream gradient g, all
// in the forward's type, writes d phi(q), d phi(k), dv in it.  strides:
// (batch, head, row) of phi(q), phi(k), v, out, g, dq, dk, dv; scratch:
// ..._scratch_floats(..., 1).
int rlmg_causal_product_bwd(const void* pq, const void* pk, const void* v, const void* out,
                            const void* den, const void* g, void* dq, void* dk, void* dv,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, int is_bf16, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return bwd<__nv_bfloat16>(pq, pk, v, out, den, g, dq, dk, dv, scratch, strides, B, H, S, E,
                              eps, st);
  return bwd<float>(pq, pk, v, out, den, g, dq, dk, dv, scratch, strides, B, H, S, E, eps, st);
}

// Calls that ran to their end on the current card since the last reset,
// as the kernel counts them: runs[0] forward, runs[1] backward.  Waits for
// the card; reset zeroes the counts after reading them.  Returns 0 or a
// CUDA error code.
int rlmg_causal_product_runs(long long* runs, int reset) {
  return rlmg::cpk::read_runs(runs, reset);
}

const char* rlmg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
