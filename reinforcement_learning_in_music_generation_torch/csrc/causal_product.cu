// Causal linear-attention product of feature-mapped q and k, forward and
// backward ("kernel F"): the CUDA counterpart of
// reinforcement_learning_in_music_generation_tpu/ops/linear_attention.py
// _fwd_pallas (Pallas body _fwd_kernel) and _bwd_pallas (_bwd_dq_kernel,
// _bwd_dkv_kernel), which replaced fast_transformers' causal_product.
//
// The passes, their bound and their design: causal_product.cuh (shared
// with kernel C's attention half).  Here they run on f32 (B, H, S, E)
// views: phi(q), phi(k), v, out and the gradients with batch / head / row
// strides that are multiples of 4 elements, 16-byte aligned bases and a
// unit last stride, so the (B, H, S, E) views of (B, S, H, E) projections
// go in and come out without copies; den (B, H, S) contiguous.

#include "causal_product.cuh"

namespace rlmg {
namespace cpk {

using FArgs = Args<float, float>;

inline Bhse<float> bhse(const void* p, const long long* s) {
  return Bhse<float>{(const float*)p, s[0], s[1], s[2]};
}

}  // namespace cpk
}  // namespace rlmg

extern "C" {

// f32 scratch floats a call at these shapes needs (0 at S <= 64): the
// prefix (and, backward, suffix) state of each tile.
long long rlmg_causal_product_scratch_floats(int B, int H, int S, int E, int backward) {
  return rlmg::cpk::scratch_floats(B, H, S, E, backward);
}

// phi(q), phi(k), v (B, H, S, E) f32 -> out (B, H, S, E) and den (B, H, S).
// strides: (batch, head, row) of phi(q), phi(k), v, out, in elements;
// scratch: rlmg_causal_product_scratch_floats(..., 0) floats.  One launch
// at S <= 64, else two (the state pass first).  Returns 0 or a CUDA error
// code.
int rlmg_causal_product_fwd(const void* pq, const void* pk, const void* v, void* out, float* den,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  FArgs a = make_args<FArgs>(H, S, E, eps, scratch);
  a.q = bhse(pq, strides);
  a.k = bhse(pk, strides + 3);
  a.v = bhse(v, strides + 6);
  a.o = bhse(out, strides + 9);
  a.den = den;
  const cudaStream_t st = (cudaStream_t)stream;
  return forward_any(a, B, st);
}

// From the forward's inputs, out and den and the upstream gradient g,
// writes d phi(q), d phi(k), dv.  strides: (batch, head, row) of phi(q),
// phi(k), v, out, g, dq, dk, dv; scratch: ..._scratch_floats(..., 1).
int rlmg_causal_product_bwd(const void* pq, const void* pk, const void* v, const void* out,
                            const float* den, const void* g, void* dq, void* dk, void* dv,
                            float* scratch, const long long* strides, int B, int H, int S,
                            int E, float eps, void* stream) {
  using namespace rlmg::cpk;
  if (!shape_ok(B, H, S, E)) return (int)cudaErrorInvalidValue;
  FArgs a = make_args<FArgs>(H, S, E, eps, scratch);
  a.q = bhse(pq, strides);
  a.k = bhse(pk, strides + 3);
  a.v = bhse(v, strides + 6);
  a.o = bhse(out, strides + 9);
  a.g = bhse(g, strides + 12);
  a.dq = bhse(dq, strides + 15);
  a.dk = bhse(dk, strides + 18);
  a.dv = bhse(dv, strides + 21);
  a.den = const_cast<float*>(den);
  const cudaStream_t st = (cudaStream_t)stream;
  return backward_any(a, B, st);
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
