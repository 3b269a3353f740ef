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
// bf16 (Args<bf16, bf16, bf16>) the tiles are copied by cp.async into one
// bf16 plane each, every product takes one mma.sync where both operands
// are bf16 and three where one is (the f32 route's bits on the widened
// tensors: the products it drops are zeros), out and den are rounded on
// store, and the backward forms dnum and dd in bf16 arithmetic from the
// rounded out and den, where _fwd_pallas / _bwd_pallas round.

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

// The premise of mma_pl (a product of zero planes leaves a sum's bits as
// they were), on the card: n tiles, one warp each, acc (16 x 8) = C0 +
// A (16 x K) B (K x 8) in depths of 16, A row-major, B given n-major (8 x
// K).  PA / PB planes an operand (mma_pl; 1 takes each value's hi plane,
// so the operand must hold bf16 values); PA = 0: acc = C0 + 0 B, one
// mma.sync of a zero A a depth.  Not on any path: a card test runs it.
template <int PA, int PB>
__global__ void __launch_bounds__(32) mma_probe_kernel(const float* A, const float* B,
                                                       const float* C0, float* C, int K) {
  const int t = blockIdx.x, g = lane_g(), t2 = 2 * lane_t();
  const float* a0 = A + (size_t)t * 16 * K;
  const float* b0 = B + (size_t)t * 8 * K;
  float acc[4];
  for (int i = 0; i < 4; ++i) acc[i] = C0[t * 128 + (g + 8 * (i >> 1)) * 8 + t2 + (i & 1)];
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[3][4], b[3][2];
    frag_a_rows(a, a0, K, k0);
    frag_b_rows(b, b0, K, k0);
    if constexpr (PA == 0) {
      const uint32_t z[4] = {0u, 0u, 0u, 0u};
      mma_bf16(acc, z, b[0]);
    } else {
      uint32_t ap[PA][4], bp[PB][2];
      for (int p = 0; p < PA; ++p)
        for (int i = 0; i < 4; ++i) ap[p][i] = a[p][i];
      for (int p = 0; p < PB; ++p)
        for (int i = 0; i < 2; ++i) bp[p][i] = b[p][i];
      mma_pl(acc, ap, bp);
    }
  }
  for (int i = 0; i < 4; ++i) C[t * 128 + (g + 8 * (i >> 1)) * 8 + t2 + (i & 1)] = acc[i];
}

}  // namespace cpk
}  // namespace rlmg

extern "C" {

// mma_probe_kernel<pa, pb> on n tiles (pa, pb: 1 or 3; pa = 0: a zero A);
// K a multiple of 16.  Returns 0 or a CUDA error code.
int rlmg_causal_product_mma_probe(const float* A, const float* B, const float* C0, float* C,
                                  int n, int K, int pa, int pb, void* stream) {
  using namespace rlmg::cpk;
  if (n <= 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int mode = pa * 10 + pb;
  switch (mode) {
    case 33: mma_probe_kernel<3, 3><<<n, 32, 0, st>>>(A, B, C0, C, K); break;
    case 31: mma_probe_kernel<3, 1><<<n, 32, 0, st>>>(A, B, C0, C, K); break;
    case 13: mma_probe_kernel<1, 3><<<n, 32, 0, st>>>(A, B, C0, C, K); break;
    case 11: mma_probe_kernel<1, 1><<<n, 32, 0, st>>>(A, B, C0, C, K); break;
    default:
      if (pa != 0) return (int)cudaErrorInvalidValue;
      mma_probe_kernel<0, 3><<<n, 32, 0, st>>>(A, B, C0, C, K);
  }
  return (int)cudaGetLastError();
}

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
